"""Sparse HAP message updates on the top-k layout (port of
``repro/kernels/topk_ops.py``; plain PyTorch, as the reference leaves them
to XLA).

Layout (produced by ``repro_torch.solver.topk``), per level:

    s, r, a : (N, kk) with kk = k + 1
    idx     : (N, kk) i32, shared across levels;
              idx[i, 0] == i (the "self" slot: preference / rho_ii /
              alpha_ii), idx[i, 1:] ascending neighbor columns.

Every function also takes a leading level dimension, (L, N, kk) and
(L, N). A missing edge is a similarity of -inf, under which the dense
updates restricted to the stored positions are exact; at k = N - 1 these
ops reproduce the dense recurrence.

The availability/tau column statistics sum max(0, rho) over *incoming*
edges. The reference scatter-adds them; on CUDA ``index_add_`` and
``scatter_add_`` use float atomics, whose order changes from run to run.
Here the incoming-edge order is built once per solve (``incoming_edges``:
a stable sort of the flattened ``idx``, i.e. each column's edges in
row-major order, the order the reference's scatter visits them) and each
column's segment is summed sequentially in that order
(``torch.segment_reduce`` over a 2-D operand, one thread per column and
level on CUDA): re-runs are bit-identical, and the sums round as the
reference's sequential scatter does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.affinity import masked_top2

NEG_INF = float("-inf")


class IncomingEdges(NamedTuple):
    """Each column's incoming edges, grouped: ``perm`` lists the flattened
    (N * kk) edge positions sorted by target column (stable, so row-major
    within a column) and column j's edges are ``perm[offsets[j]:
    offsets[j + 1]]``."""
    perm: torch.Tensor       # (N * kk,) int64
    offsets: torch.Tensor    # (N + 1,) int64


def incoming_edges(idx: torch.Tensor,
                   n_total: Optional[int] = None) -> IncomingEdges:
    """Group the edges of ``idx`` (B, kk) by target column, once per
    solve (``idx`` is fixed for the whole solve). The columns run to
    ``n_total`` (default B, the whole graph); a row block of a sharded
    sweep passes the global point count, so its partial column sums line
    up with every other block's."""
    flat = idx.reshape(-1).long()
    perm = torch.argsort(flat, stable=True)
    counts = torch.bincount(
        flat, minlength=idx.shape[0] if n_total is None else n_total)
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return IncomingEdges(perm, offsets)


def with_carry(edges: IncomingEdges) -> IncomingEdges:
    """The grouping with one more term at the head of every column's
    segment: the carry that ``col_partial_topk(..., carry=)`` appends after
    the E edges (flat position E + j for column j)."""
    n = edges.offsets.numel() - 1
    e = edges.perm.numel()
    offsets = edges.offsets + torch.arange(n + 1, device=edges.perm.device)
    heads = offsets[:-1]
    perm = torch.empty(e + n, dtype=torch.int64, device=edges.perm.device)
    perm[heads] = e + torch.arange(n, device=edges.perm.device)
    rest = torch.ones(e + n, dtype=torch.bool, device=edges.perm.device)
    rest[heads] = False
    perm[rest] = edges.perm
    return IncomingEdges(perm, offsets)


def rho_topk(s: torch.Tensor, a: torch.Tensor,
             tau: torch.Tensor) -> torch.Tensor:
    """Eq 2.1 on stored entries: rho_p = s_p + min(tau_i, -max_{q!=p}(a+s));
    absent columns carry -inf and never win the row max."""
    m1, i1, m2 = masked_top2(a + s)
    pos = torch.arange(s.shape[-1], device=s.device)
    row_max_excl = torch.where(pos == i1.unsqueeze(-1), m2.unsqueeze(-1),
                               m1.unsqueeze(-1))
    return s + torch.minimum(tau.unsqueeze(-1), -row_max_excl)


def col_partial_topk(r: torch.Tensor, edges: IncomingEdges,
                     carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (N,) availability column sum: max(0, rho) over the stored
    edges into each column, self slot excluded, each column's edges summed
    in row-major order. With ``carry`` (one value a column, ``edges`` from
    ``with_carry``) each column's sum starts from its carry: a row block
    continues the sum of the blocks before it."""
    rp = r.clamp_min(0.0)
    rp = torch.cat([torch.zeros_like(rp[..., :1]), rp[..., 1:]], dim=-1)
    lead, n = rp.shape[:-2], edges.offsets.numel() - 1
    flat = rp.reshape(-1, rp.shape[-2] * rp.shape[-1])       # (L', E)
    if flat.shape[0] == 0:                                   # no levels
        return rp.new_zeros((*lead, n))
    if carry is not None:
        flat = torch.cat([flat, carry.reshape(flat.shape[0], n)], dim=1)
    grouped = flat[:, edges.perm].T.contiguous()             # (E, L')
    col = torch.segment_reduce(grouped, "sum", offsets=edges.offsets,
                               axis=0, unsafe=True)          # (n, L')
    return col.T.reshape(*lead, n)


def col_stats_topk(r: torch.Tensor, edges: IncomingEdges):
    """(col, rdiag): ``col`` (N,) the clamped incoming-edge column sum,
    ``rdiag`` (N,) the self slot rho_jj."""
    return col_partial_topk(r, edges), r[..., 0]


def alpha_from_stats(r: torch.Tensor, idx: torch.Tensor, col: torch.Tensor,
                     base: torch.Tensor, rdiag: torch.Tensor) -> torch.Tensor:
    """Eq 2.2/2.3 for a row block given column statistics indexed by
    global column: ``col`` (availability column sums), ``base`` (c + phi)
    and ``rdiag`` (rho self slot)."""
    rp = r.clamp_min(0.0)
    a_off = (base[..., idx] + rdiag[..., idx] + col[..., idx]
             - rp).clamp_max(0.0)
    rows = idx[:, 0].long()                 # global row of each block row
    a_self = base[..., rows] + col[..., rows]   # diagonal rule, no clamp
    return torch.cat([a_self.unsqueeze(-1), a_off[..., 1:]], dim=-1)


def alpha_topk(r: torch.Tensor, c: torch.Tensor, phi: torch.Tensor,
               idx: torch.Tensor, edges: IncomingEdges) -> torch.Tensor:
    """Eq 2.2/2.3 on stored entries via the column statistics."""
    col, rdiag = col_stats_topk(r, edges)
    return alpha_from_stats(r, idx, col, c + phi, rdiag)


def tau_from_stats(c: torch.Tensor, rdiag: torch.Tensor,
                   col: torch.Tensor) -> torch.Tensor:
    """Eq 2.4 with all three operands aligned to the rows."""
    return c + rdiag + col


def tau_topk(r: torch.Tensor, c: torch.Tensor,
             edges: IncomingEdges) -> torch.Tensor:
    """Eq 2.4: tau_j^{l+1} = c_j + rho_jj + sum_{k!=j} max(0, rho_kj)."""
    col, rdiag = col_stats_topk(r, edges)
    return tau_from_stats(c, rdiag, col)


def phi_topk(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Eq 2.5: phi_i^{l-1} = max over stored positions of (alpha + s)."""
    return (a + s).amax(dim=-1)


def c_topk(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Eq 2.6: c_i = max over stored positions of (alpha + rho)."""
    return (a + r).amax(dim=-1)


def s_next_topk(s_next: torch.Tensor, a: torch.Tensor, r: torch.Tensor,
                kappa: float, mode: str) -> torch.Tensor:
    """Eq 2.7 on the compressed layout; the self slot (preference) and the
    sparsity pattern are kept, as ``core.hap.s_next_level`` keeps them."""
    if mode == "paper":
        v = a + r
        v = torch.cat([torch.full_like(v[..., :1], NEG_INF), v[..., 1:]],
                      dim=-1)
        out = s_next + (kappa * v.amax(dim=-1)).unsqueeze(-1)
    elif mode == "evidence":
        out = s_next + kappa * (a + r)
    else:
        return s_next
    return torch.cat([s_next[..., :1], out[..., 1:]], dim=-1)


def assignments_topk(a: torch.Tensor, r: torch.Tensor, idx: torch.Tensor,
                     n_total: Optional[int] = None) -> torch.Tensor:
    """Eq 2.8 decode: argmax of (alpha + rho) over stored positions, mapped
    to global columns; ties break on the *global* column (the smallest),
    as the dense ``argmax`` does, not on the stored position (the self
    slot comes first). ``n_total`` is the global point count when the
    operands are a row block: the sentinel must lie past every column."""
    v = a + r
    m = v.amax(dim=-1, keepdim=True)
    n = idx.shape[0] if n_total is None else n_total
    cand = torch.where(v == m, idx.to(torch.int64), n)
    return cand.amin(dim=-1).to(torch.int32)
