"""MR-HAP: the paper's MapReduce parallelization of HAP, on the ranks of a
``torch.distributed`` group (port of ``repro/core/mrhap.py``).

The paper (§3) splits each HAP iteration into three MapReduce jobs and
moves the (L, N, N) message tensors between *exemplar-based* (column) and
*node-based* (row) shardings; the Hadoop shuffle is a distributed
transpose. Here each worker is one rank of a ``launch.mesh.WorkerMesh``
that runs the reference's ``shard_map`` body on its own block, through the
collectives of ``sharding.dist``, with two communication modes on a 1-D
``workers`` axis:

* ``transpose`` (paper-faithful): rho lives row-sharded (Job 1's reducer
  layout), alpha column-sharded (Job 2's), and each iteration makes the
  paper's two format switches as ``all_to_all`` transposes (O(L*N^2/W)
  moved per worker per iteration). Job 3's final switch is one more
  ``all_to_all`` at extraction.
* ``stats`` (beyond the paper): every tensor stays row-sharded; the
  cross-worker reductions of Eq 2.2/2.3/2.4 are column sums of
  max(0, rho) and diagonals, so only O(L*N) statistics are exchanged.

and a 2-D tile decomposition (``run_mrhap_2d``) over ``rows`` x ``cols``.
All follow the Jacobi schedule (tau and c skipped on the first iteration,
phi read from the old alpha) and match ``core.hap.run_hap(order=
"parallel")`` up to float reduction order.

Every rank passes the whole (L, N, N) stack and gets the whole exemplar
array back; ``r`` and ``a`` of the result are this rank's block (rows, or
a tile on the 2-D mesh), not gathered.
"""
from __future__ import annotations

from typing import Literal, NamedTuple

import torch

from repro_torch.core import hap
from repro_torch.core.affinity import masked_top2
from repro_torch.sharding.dist import (
    Axis, all_gather, all_to_all, pmax, pmin, psum,
)
from repro_torch.sharding.partitioning import row_block

CommMode = Literal["stats", "transpose"]
AXIS = "workers"
AXIS_R, AXIS_C = "rows", "cols"


class MRHAPResult(NamedTuple):
    exemplars: torch.Tensor   # (L, N) int32, the same on every rank
    n_clusters: torch.Tensor  # (L,)
    r: torch.Tensor           # this rank's block of the responsibilities
    a: torch.Tensor           # this rank's block of the availabilities


def _n_clusters(e: torch.Tensor) -> torch.Tensor:
    hot = torch.zeros(e.shape, dtype=torch.bool, device=e.device)
    hot.scatter_(1, e.long(), True)
    return hot.sum(dim=1).to(torch.int32)


def _tau_from_stats(c_g, diag_g, col_g, first: bool) -> torch.Tensor:
    """Eq 2.4 for the level above, tau[0] = +inf; all +inf on sweep 0."""
    tau_upper = c_g + diag_g + col_g
    inf_row = torch.full_like(tau_upper[:1], float("inf"))
    tau_g = torch.cat([inf_row, tau_upper[:-1]], dim=0)
    return torch.full_like(tau_g, float("inf")) if first else tau_g


def _phi_rows(a, s) -> torch.Tensor:
    """Eq 2.5 from the OLD alpha on a row block; phi[L-1] = 0."""
    phi = (a[1:] + s[1:]).amax(dim=2)
    return torch.cat([phi, torch.zeros_like(phi[:1])], dim=0)


# ------------------------------------------------------------- stats mode
def _alpha_rows(r, c_g, phi_g, col_g, diag_g, eye):
    """Eq 2.2/2.3 on a (L, Nl, N) row block from global column statistics:
    col_g[l, j] = sum_{k != j} max(0, rho_kj), diag_g[l, j] = rho_jj."""
    rp = torch.where(eye, 0.0, r.clamp_min(0.0))       # exclude own diag
    base = (c_g + phi_g)[:, None, :]
    a_off = (base + (diag_g + col_g)[:, None, :] - rp).clamp_max(0.0)
    a_diag = base + col_g[:, None, :]
    return torch.where(eye, a_diag, a_off)


def _sweep_stats(carry, first: bool, *, s_loc, lam, rows, eye, ax: Axis):
    """One MR iteration, every tensor row-sharded, O(L*N) exchanged.

    carry: r, a (L, Nl, N); c_g, col_g, diag_g (L, N), the last two the
    statistics of the carried rho (Job 1 reuses Job 2's reduction)."""
    r, a, c_g, col_g, diag_g = carry
    nl = rows.shape[0]

    # --- Job 1: tau, c (kept on the first iteration), then rho
    tau_g = _tau_from_stats(c_g, diag_g, col_g, first)
    c_new_g = all_gather((a + r).amax(dim=2), ax, axis=1)
    if not first:
        c_g = c_new_g
    r = hap._damp(r, hap.rho_update(s_loc, a, tau_g[:, rows]), lam)

    # --- Job 2: phi, then alpha
    phi_g = all_gather(_phi_rows(a, s_loc), ax, axis=1)
    col_g = psum(torch.where(eye, 0.0, r.clamp_min(0.0)).sum(dim=1), ax)
    diag_g = all_gather(r[:, torch.arange(nl, device=r.device), rows], ax,
                        axis=1)
    a = hap._damp(a, _alpha_rows(r, c_g, phi_g, col_g, diag_g, eye), lam)
    return r, a, c_g, col_g, diag_g


def _run_stats(s_loc, rows, ax: Axis, iterations: int, lam: float):
    levels, _, n = s_loc.shape
    zero_g = s_loc.new_zeros((levels, n))
    carry = (torch.zeros_like(s_loc), torch.zeros_like(s_loc), zero_g,
             zero_g, zero_g)
    eye = rows[:, None] == torch.arange(n, device=s_loc.device)[None, :]
    for it in range(iterations):
        carry = _sweep_stats(carry, it == 0, s_loc=s_loc, lam=lam, rows=rows,
                             eye=eye, ax=ax)
    r, a = carry[0], carry[1]
    return (a + r).argmax(dim=2).to(torch.int32), r, a


# --------------------------------------------------------- transpose mode
def _sweep_transpose(carry, first: bool, *, s_row, lam, rows, eye_col,
                     ax: Axis):
    """One MR iteration with the paper's two format switches (shuffles).

    rho is node-based (row-sharded, (L, Nl, N)) and also kept
    exemplar-based ((L, N, Nl)); alpha is exemplar-based. all_to_all #1
    moves alpha to node format for the rho update, #2 the fresh rho to
    exemplar format for the alpha update."""
    r_row, r_col, a_col, c_g = carry
    nl = rows.shape[0]
    local = torch.arange(nl, device=rows.device)

    # --- Job 1 mapper side: column statistics from exemplar-based rho
    rp = torch.where(eye_col, 0.0, r_col.clamp_min(0.0))
    col_g = all_gather(rp.sum(dim=1), ax, axis=1)
    diag_g = all_gather(r_col[:, rows, local], ax, axis=1)
    tau_g = _tau_from_stats(c_g, diag_g, col_g, first)

    # --- shuffle #1: alpha exemplar-format -> node-format
    a_row = all_to_all(a_col, ax, split_axis=1, concat_axis=2)
    c_new_g = all_gather((a_row + r_row).amax(dim=2), ax, axis=1)
    if not first:
        c_g = c_new_g
    r_row = hap._damp(r_row, hap.rho_update(s_row, a_row, tau_g[:, rows]),
                      lam)

    # --- shuffle #2: fresh rho node-format -> exemplar-format
    r_col = all_to_all(r_row, ax, split_axis=2, concat_axis=1)

    # --- Job 2: phi (row-local on the old alpha), then alpha (column-local)
    phi_g = all_gather(_phi_rows(a_row, s_row), ax, axis=1)
    rp_new = torch.where(eye_col, 0.0, r_col.clamp_min(0.0))
    col_new = rp_new.sum(dim=1)                           # (L, Nl) own cols
    rdiag_new = r_col[:, rows, local]
    base = (c_g[:, rows] + phi_g[:, rows])[:, None, :]    # (L, 1, Nl)
    a_off = (base + (rdiag_new + col_new)[:, None, :] - rp_new).clamp_max(0.0)
    a_diag = base + col_new[:, None, :]
    a_col = hap._damp(a_col, torch.where(eye_col, a_diag, a_off), lam)
    return r_row, r_col, a_col, c_g


def _run_transpose(s_row, rows, ax: Axis, iterations: int, lam: float):
    levels, nl, n = s_row.shape
    z_col = s_row.new_zeros((levels, n, nl))
    carry = (torch.zeros_like(s_row), z_col, z_col.clone(),
             s_row.new_zeros((levels, n)))
    eye_col = torch.arange(n, device=s_row.device)[:, None] == rows[None, :]
    for it in range(iterations):
        carry = _sweep_transpose(carry, it == 0, s_row=s_row, lam=lam,
                                 rows=rows, eye_col=eye_col, ax=ax)
    r_row, _, a_col, _ = carry
    # Job 3's final format switch: alpha back to node format for extraction
    a_row = all_to_all(a_col, ax, split_axis=1, concat_axis=2)
    return (a_row + r_row).argmax(dim=2).to(torch.int32), r_row, a_row


def run_mrhap(s3: torch.Tensor, mesh, *, iterations: int = 30,
              damping: float = 0.5, comm_mode: CommMode = "stats",
              axis_name: str = AXIS) -> MRHAPResult:
    """Distributed HAP over ``mesh``'s axis ``axis_name``; N must split
    evenly (``repro_torch.solver.solve`` with backend ``mr1d_stats`` or
    ``mr1d_transpose`` pads with ``pad_similarity`` and strips the
    dummies)."""
    levels, n, n2 = s3.shape
    if n != n2:
        raise ValueError(f"similarity tensor must be (L, N, N); got "
                         f"{tuple(s3.shape)}")
    ax = mesh.axis(axis_name)
    if n % ax.size:
        raise ValueError(
            f"N={n} must be divisible by workers={ax.size}; pad with "
            "repro_torch.core.mrhap.pad_similarity first.")
    if comm_mode not in ("stats", "transpose"):
        raise ValueError(f"unknown comm_mode {comm_mode!r}")
    s_row = row_block(s3.float(), mesh, axis_name, axis=1)
    nl = n // ax.size
    rows = ax.index * nl + torch.arange(nl, device=s3.device)
    run = _run_stats if comm_mode == "stats" else _run_transpose
    e_loc, r, a = run(s_row, rows, ax, iterations, damping)
    e = all_gather(e_loc, ax, axis=1)
    return MRHAPResult(e, _n_clusters(e), r, a)


def gather_blocks(block: torch.Tensor, mesh) -> torch.Tensor:
    """The whole (L, N, N) tensor from every rank's block of a result's
    ``r`` or ``a``: row blocks on a 1-D ``workers`` mesh, tiles on a
    ``rows`` x ``cols`` mesh (gathered along the columns, then the rows)."""
    if tuple(mesh.axis_names) == (AXIS_R, AXIS_C):
        block = all_gather(block, mesh.axis(AXIS_C), axis=2)
        return all_gather(block, mesh.axis(AXIS_R), axis=1)
    return all_gather(block, mesh.axis(AXIS), axis=1)


# -------------------------------------------------------------- utilities
def pad_similarity(s3: torch.Tensor, multiple: int,
                   neg: float = -1.0e9) -> tuple[torch.Tensor, int]:
    """Pad (L, N, N) to N' = ceil(N/multiple)*multiple with inert dummies.

    Dummy points repel everything (2*neg) but mildly prefer themselves
    (neg), so each becomes its own singleton exemplar and never perturbs
    real clusters. Returns (padded tensor, original N)."""
    levels, n, _ = s3.shape
    pad = (-n) % multiple
    if pad == 0:
        return s3, n
    np_ = n + pad
    out = torch.full((levels, np_, np_), 2.0 * neg, dtype=s3.dtype,
                     device=s3.device)
    out[:, :n, :n] = s3
    idx = torch.arange(n, np_, device=s3.device)
    out[:, idx, idx] = neg
    return out, n


def comm_bytes_per_iteration(n: int, levels: int, workers: int,
                             mode: CommMode, bytes_per_el: int = 4) -> int:
    """Analytic per-iteration communication volume (whole cluster).

    transpose: two all_to_alls of an (L, N, N) tensor — each worker sends
    (W-1)/W of its L*N*N/W elements, summed over workers; plus the O(L*N)
    gathers shared with stats mode.
    stats: one psum + three all_gathers of (L, N) vectors
    (ring: each moves ~2*(W-1)/W * L*N elements cluster-wide)."""
    small = 4 * levels * n * (workers - 1) * 2 * bytes_per_el
    if mode == "stats":
        return small
    big = 2 * levels * n * n * (workers - 1) // workers * bytes_per_el
    return big + small


# ===================================================================== 2-D
# Beyond the paper's parallelism ceiling (M <= L*N workers, §3.1): sharding
# both tensor axes over a rows x cols mesh lifts it to L*N^2/tile; every
# reduction stays tile-local or becomes a psum / pmax merge of O(L*N/axis)
# statistics.
def _row_top2_2d(v, col0: int, ac: Axis):
    """Row top-2 across column tiles through pmax/pmin (the same on every
    rank of the row). First-occurrence ties: the winner is the smallest
    global column among value-ties (as ``argmax``), and a duplicated max
    on a losing tile becomes the second max."""
    m1, i1, m2 = masked_top2(v)
    i1 = i1 + col0
    g1 = pmax(m1, ac)
    gidx = pmin(torch.where(m1 == g1, i1, 2 ** 30), ac)
    g2 = pmax(torch.where(i1 == gidx, m2, m1), ac)
    return g1, gidx, g2


def _sweep_stats_2d(carry, first: bool, *, s_loc, lam, rows, cols, eye,
                    ar: Axis, ac: Axis):
    """One MR iteration on (L, nr, nc) tiles; all cross-tile traffic is
    O(L*N/axis) statistics."""
    r, a, c_g, col_c, diag_c = carry

    # --- Job 1: tau (column stats of the previous rho), c, then rho
    tau_g = all_gather(c_g[:, cols] + diag_c + col_c, ac, axis=1)
    inf_row = torch.full_like(tau_g[:1], float("inf"))
    tau_g = torch.cat([inf_row, tau_g[:-1]], dim=0)
    if first:
        tau_g = torch.full_like(tau_g, float("inf"))
    c_rows = pmax((a + r).amax(dim=2), ac)                # full row max
    c_new_g = all_gather(c_rows, ar, axis=1)
    if not first:
        c_g = c_new_g
    m1, i1, m2 = _row_top2_2d(a + s_loc, ac.index * cols.shape[0], ac)
    row_max = torch.where(cols[None, None, :] == i1[..., None],
                          m2[..., None], m1[..., None])
    r = hap._damp(
        r, s_loc + torch.minimum(tau_g[:, rows][..., None], -row_max), lam)

    # --- Job 2: phi (from the old alpha), then alpha
    phi_g = all_gather(pmax((a + s_loc).amax(dim=2), ac), ar, axis=1)
    phi_g = torch.cat([phi_g[1:], torch.zeros_like(phi_g[:1])], dim=0)
    rp = torch.where(eye, 0.0, r.clamp_min(0.0))
    col_c = psum(rp.sum(dim=1), ar)                         # (L, nc)
    diag_c = psum(torch.where(eye, r, 0.0).sum(dim=1), ar)
    base = c_g[:, cols] + phi_g[:, cols]
    a_off = ((base + diag_c + col_c)[:, None, :] - rp).clamp_max(0.0)
    a_diag = (base + col_c)[:, None, :]
    a = hap._damp(a, torch.where(eye, a_diag, a_off), lam)
    return r, a, c_g, col_c, diag_c


def run_mrhap_2d(s3: torch.Tensor, mesh, *, iterations: int = 30,
                 damping: float = 0.5, row_axis: str = AXIS_R,
                 col_axis: str = AXIS_C) -> MRHAPResult:
    """2-D tile-decomposed MR-HAP over ``mesh[row_axis] x
    mesh[col_axis]`` (``solve`` backend ``mr2d`` pads and strips)."""
    levels, n, n2 = s3.shape
    if n != n2:
        raise ValueError(f"similarity tensor must be (L, N, N); got "
                         f"{tuple(s3.shape)}")
    ar, ac = mesh.axis(row_axis), mesh.axis(col_axis)
    if n % ar.size or n % ac.size:
        raise ValueError(f"N={n} must divide both mesh axes "
                         f"({ar.size}, {ac.size})")
    nr, nc = n // ar.size, n // ac.size
    dev = s3.device
    rows = ar.index * nr + torch.arange(nr, device=dev)
    cols = ac.index * nc + torch.arange(nc, device=dev)
    s_loc = s3.float()[:, ar.index * nr:(ar.index + 1) * nr,
                       ac.index * nc:(ac.index + 1) * nc].contiguous()
    eye = rows[:, None] == cols[None, :]
    zero_c = s_loc.new_zeros((levels, nc))
    carry = (torch.zeros_like(s_loc), torch.zeros_like(s_loc),
             s_loc.new_zeros((levels, n)), zero_c, zero_c)
    for it in range(iterations):
        carry = _sweep_stats_2d(carry, it == 0, s_loc=s_loc, lam=damping,
                                rows=rows, cols=cols, eye=eye, ar=ar, ac=ac)
    r, a = carry[0], carry[1]
    # extraction: row argmax of (a + r) merged across column tiles
    _, i1, _ = _row_top2_2d(a + r, ac.index * nc, ac)
    e = all_gather(i1.to(torch.int32), ar, axis=1)
    return MRHAPResult(e, _n_clusters(e), r, a)
