"""Row-sharded ``dense_topk`` sweeps over the ranks of a 1-D ``workers``
mesh (port of ``repro/solver/topk_sharded.py``).

The (L, N, k+1) message tensors are split into row blocks, one per rank,
and every rank runs the whole Jacobi loop (``core.hap.jacobi_sweep``
through ``dense.drive_sweeps``'s stopping rule) on its block. Per sweep
(B = N/W local rows):

* rho (Eq 2.1), phi (2.5), c (2.6), the Eq 2.7 refinement and the Eq 2.8
  decode are row reductions: rank-local, the ``kernels.topk_ops`` ops of
  the one-device loop;
* the availability/tau column statistics sum max(0, rho) over *incoming*
  edges, whose sources live on other ranks. That one primitive is an
  exchange (``SolveConfig.exchange``):

  ``allgather`` — the ranks gather the (B, k+1) rho blocks and run the
  one-device loop's ordered column sum over the full edge set, so the
  sweep is bit-identical to ``run_topk`` (trace included); O(N*k)
  gathered per level per evaluation.

  ``psum`` — each rank sums its rows' contributions into a full-length
  (N,) partial (its edges grouped over all N columns), continuing the
  partial of the ranks before it (``sharding.dist.chain_sum``), and the
  last rank's sums are broadcast: O(N) traffic a hop, and the one-device
  summation order, so this exchange is bit-identical to ``run_topk`` too
  (the reference's psum all-reduces per-block partials and differs from
  its oracle by ulps, which can move tied decisions).

  ``auto`` takes allgather until the edge list outgrows
  ``ALLGATHER_MAX_ELEMS``, then psum.

* the ``stop="converged"`` change counter is masked to real rows and
  summed over the ranks, so every rank stops on the one-device run's
  sweep.

N is padded to the worker multiple with inert dummy rows (``pad_topk``):
a dummy's slots all point back at itself with repelling values, so real
columns never receive a dummy contribution and the decode pins dummies to
themselves.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import hap
from repro_torch.kernels.topk_ops import (
    alpha_from_stats, assignments_topk, c_topk, col_partial_topk,
    col_stats_topk, incoming_edges, phi_topk, rho_topk, s_next_topk,
    tau_from_stats, with_carry,
)
from repro_torch.sharding.dist import Axis, all_gather, chain_sum
from repro_torch.sharding.partitioning import row_block
from repro_torch.solver import dense
from repro_torch.solver.topk import TopKState

AXIS = "workers"

#: every sweep-execution mode; "auto" resolves per problem/host
SWEEP_MODES = ("auto", "single", "sharded")

#: column-exchange strategies for the sharded sweep
EXCHANGE_MODES = ("auto", "allgather", "psum")

#: N at which a group of several ranks switches the sweeps to the sharded
#: driver (the build switches earlier: it is O(N^2) work, a sweep O(N*k))
SHARDED_SWEEP_N = 32768

#: padded edge count (N * (k + 1)) above which "auto" takes the O(N) psum
#: exchange over the O(N * k) allgather
ALLGATHER_MAX_ELEMS = 1 << 24


def resolve_sweep(name: str, *, n: int, n_devices: int = 1) -> str:
    """``cfg.sweep`` -> "single" | "sharded" for this problem; ``solve``
    passes the group's rank count as ``n_devices``."""
    if name not in SWEEP_MODES:
        raise ValueError(
            f"unknown sweep mode {name!r}; known: {SWEEP_MODES}")
    if name != "auto":
        return name
    if n_devices > 1 and n >= SHARDED_SWEEP_N:
        return "sharded"
    return "single"


def resolve_exchange(name: str, *, n: int, kk: int) -> str:
    """``cfg.exchange`` -> a concrete exchange for this layout."""
    if name not in EXCHANGE_MODES:
        raise ValueError(
            f"unknown exchange mode {name!r}; known: {EXCHANGE_MODES}")
    if name != "auto":
        return name
    return "allgather" if n * kk <= ALLGATHER_MAX_ELEMS else "psum"


def pad_topk(s3k: torch.Tensor, idx: torch.Tensor, multiple: int,
             neg: float = -1.0e9):
    """Pad a compressed (L, N, kk) stack to a row multiple with inert
    dummies (``core.mrhap.pad_similarity``'s convention on the top-k
    layout): self slot ``neg``, neighbors ``2*neg``, every slot pointing
    back at the dummy row. Returns ``(padded stack, padded index map,
    original N)``; already divisible input comes back as it is."""
    levels, n, kk = s3k.shape
    pad = (-n) % multiple
    if pad == 0:
        return s3k, idx, n
    s_pad = torch.full((levels, pad, kk), 2.0 * neg, dtype=s3k.dtype,
                       device=s3k.device)
    s_pad[:, :, 0] = neg
    dummy = torch.arange(n, n + pad, dtype=idx.dtype, device=idx.device)
    return (torch.cat([s3k, s_pad], dim=1),
            torch.cat([idx, dummy[:, None].expand(pad, kk)], dim=0), n)


def comm_bytes_per_sweep(n: int, k: int, levels: int, workers: int,
                         exchange: str, bytes_per_el: int = 4) -> int:
    """Analytic per-sweep cluster communication volume.

    Both exchanges pay the O(L*N) statistics gathers (base = c + phi per
    level, rdiag + the change counter); allgather additionally moves the
    (N, k+1) rho blocks for every column-statistics evaluation (twice
    per sweep: tau on levels 0..L-2, alpha on all levels), psum an (N,)
    partial each. Ring collectives move ~2*(W-1)/W * payload cluster-wide.
    """
    ring = 2 * (workers - 1) * bytes_per_el
    stats_calls = (levels - 1) + levels            # tau + alpha evaluations
    small = (levels + stats_calls) * n * ring      # base gathers + rdiag/psum
    if exchange == "psum":
        return small + stats_calls * n * ring      # the (N,) partial psums
    return small + stats_calls * n * (k + 1) * ring


def make_sharded_sweep(idx_loc: torch.Tensor, ax: Axis, n_total: int,
                       exchange: str, *, damping: float, kappa: float,
                       s_mode: str):
    """The ``(sweep, assign)`` pair of one rank's row block ``idx_loc``
    (B, kk): ``topk.make_topk_sweep`` with the column statistics
    exchanged over ``ax``."""
    rows = idx_loc[:, 0].long()                 # global row of each block row
    if exchange == "allgather":
        edges = incoming_edges(all_gather(idx_loc, ax, axis=0))

        def col_stats(r):                        # (L', B, kk) -> 2 x (L', N)
            return col_stats_topk(all_gather(r, ax, axis=-2), edges)
    else:
        edges = with_carry(incoming_edges(idx_loc, n_total))

        def col_stats(r):
            return (chain_sum(lambda carry: col_partial_topk(r, edges, carry),
                              r.new_zeros((*r.shape[:-2], n_total)), ax),
                    all_gather(r[..., 0], ax, axis=-1))

    def tau(r, c):                               # levels 0..L-2
        if r.shape[0] == 0:
            return c.new_zeros((0, rows.shape[0]))
        col, _ = col_stats(r)
        return tau_from_stats(c, r[..., 0], col[..., rows])

    reducers = hap.SweepReducers(tau=tau, phi=phi_topk, c=c_topk,
                                 s_next=s_next_topk)

    def update_r(s, a, tau_, r):
        return hap._damp(r, rho_topk(s, a, tau_), damping)

    def update_a(r, c, phi, a):
        col, rdiag = col_stats(r)
        base = all_gather(c + phi, ax, axis=-1)
        return hap._damp(a, alpha_from_stats(r, idx_loc, col, base, rdiag),
                         damping)

    def sweep(state, it):
        return hap.jacobi_sweep(
            state, it == 0, lam=damping, kappa=kappa, s_mode=s_mode,
            update_r=update_r, update_a=update_a, reducers=reducers)

    def assign(state):
        return assignments_topk(state.a, state.r, idx_loc, n_total=n_total)

    return sweep, assign


class ShardedSweep(NamedTuple):
    """One rank's part of a row-sharded sparse loop: its row blocks of the
    padded stack and index map, the ``(sweep, assign)`` pair of
    ``make_sharded_sweep``, the change counter's mask of real rows, and
    the mesh axis the exchanges run over."""
    ax: Axis
    s_loc: torch.Tensor            # (L, B, kk) this rank's rows
    idx_loc: torch.Tensor          # (B, kk) their global destination ids
    n_real: int                    # rows before padding
    exchange: str                  # the resolved column exchange
    sweep: Callable
    assign: Callable
    count_mask: torch.Tensor       # (B,) bool: real rows

    @property
    def row0(self) -> int:
        """Global id of this rank's first row."""
        return self.ax.index * self.idx_loc.shape[0]

    def drive(self, *, max_iterations: int, stop: str, patience: int,
              segmented: bool = False, carry=None, until=None):
        """``dense.drive_sweeps`` on this rank's block: the whole run, or
        (``segmented``) one checkpoint segment from ``carry`` to
        ``until``. Every call runs the same sweep closure, so a plain, a
        checkpointed and a resumed run are the same op sequence."""
        init = hap.hap_init(self.s_loc) if carry is None else None
        return dense.drive_sweeps(
            init, self.sweep, self.assign,
            self.s_loc.shape[0], self.idx_loc.shape[0],
            max_iterations=max_iterations, stop=stop, patience=patience,
            count_mask=self.count_mask, axis=self.ax, segmented=segmented,
            carry=carry, until=until)


def prepare_sharded(s3k: torch.Tensor, idx: torch.Tensor, mesh, *,
                    exchange: str = "auto", damping: float = 0.5,
                    kappa: float = 0.0, s_mode: str = "off",
                    axis_name: str = AXIS) -> ShardedSweep:
    """Pad the (L, N, kk) stack to the rank count, take this rank's row
    blocks and build its sweep: the set-up that ``run_topk_sharded`` and
    the checkpointed runner (``solver.checkpointing``) share."""
    if tuple(mesh.axis_names) != (axis_name,):
        raise ValueError(
            f"sharded sweeps need a 1-D mesh with axis {axis_name!r} "
            f"(got axes {tuple(mesh.axis_names)}); build one with "
            "repro_torch.launch.mesh.make_worker_mesh()")
    ax = mesh.axis(axis_name)
    s3k = s3k.float()
    kk = s3k.shape[-1]
    s3k_p, idx_p, n_real = pad_topk(s3k, idx, ax.size)
    n_total = s3k_p.shape[1]
    s_loc = row_block(s3k_p, mesh, axis_name, axis=1)
    idx_loc = row_block(idx_p, mesh, axis_name, axis=0)
    exchange = resolve_exchange(exchange, n=n_total, kk=kk)
    sweep, assign = make_sharded_sweep(
        idx_loc, ax, n_total, exchange, damping=damping, kappa=kappa,
        s_mode=s_mode)
    return ShardedSweep(ax, s_loc, idx_loc, n_real, exchange, sweep, assign,
                        idx_loc[:, 0] < n_real)


def run_topk_sharded(s3k: torch.Tensor, idx: torch.Tensor, mesh, *,
                     max_iterations: int, damping: float = 0.5,
                     kappa: float = 0.0, s_mode: str = "off",
                     stop: str = "fixed", patience: int = 5,
                     exchange: str = "auto", axis_name: str = AXIS):
    """Run the sparse Jacobi schedule row-sharded over ``mesh[axis_name]``.

    Every rank passes the whole (L, N, kk) stack and ``idx``. Same return
    contract as ``run_topk`` — ``(TopKState, exemplars, n_sweeps,
    converged, trace)`` — with the exemplars in the padded N' (the engine
    strips the dummies) and the state this rank's row block
    (``gather_state`` assembles it). Exemplars, trace, sweep count and flag
    equal the one-device oracle's, and under ``exchange="allgather"`` the
    state is bit-identical to it.
    """
    run = prepare_sharded(s3k, idx, mesh, exchange=exchange,
                          damping=damping, kappa=kappa, s_mode=s_mode,
                          axis_name=axis_name)
    state, e, n_sweeps, conv, trace = run.drive(
        max_iterations=max_iterations, stop=stop, patience=patience)
    return (TopKState(state, run.idx_loc), all_gather(e, run.ax, axis=1),
            n_sweeps, conv, trace)


def gather_state(state, mesh, axis_name: str = AXIS):
    """The whole padded ``TopKState`` from every rank's row block."""
    ax = mesh.axis(axis_name)
    return TopKState(
        hap.HAPState(*(all_gather(t, ax, axis=1) for t in state.hap)),
        all_gather(state.idx, ax, axis=0))
