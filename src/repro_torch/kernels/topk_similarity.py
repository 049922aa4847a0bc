"""Top-k-per-row similarity builds (port of
``repro/kernels/topk_similarity.py``).

Every build produces the compressed layout the ``dense_topk`` sweeps
consume:

    vals (N, k) f32   top-k *off-diagonal* similarities per row
    idx  (N, k) i32   their column indices, ascending per row

The diagonal (preference) is excluded; the solver prepends it as the
"self" slot (``repro_torch.solver.topk``).

Tie-break contract: the selected edge set is the top-k under "larger value
first, smaller column first among equal values". The reference gets it
from ``lax.top_k``'s positional stability; ``torch.topk`` promises no
order among equal values, so every selection here is a stable descending
``torch.sort`` (equal values keep their positions) cut to its first k.

``topk_similarity`` is the reference scan: it streams (block_rows,
block_cols) similarity tiles in ascending column order and folds each
into a running per-row top-k. For neg-sqeuclidean its tiles come from the
similarity kernel's wrapper (``kernels.similarity``): the CUDA kernel on
the card, its plain version on the CPU — as the reference takes its tiles
from ``similarity_pallas`` on its accelerator. The two-stage gated build
(``topk_similarity_twostage``) is not ported yet (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.similarity import _METRICS
from repro_torch.kernels import similarity

NEG_INF = float("-inf")

#: beyond this N the exact tie-break select (column ids embedded in f32
#: keys) would lose integer precision; the reference scan has no such cap.
SELECT_EXACT_MAX_N = 1 << 24


def _check_k(k: int, n: int) -> None:
    if not 1 <= k <= n - 1:
        raise ValueError(f"k must be in [1, N-1] = [1, {n - 1}]; got {k}")


def _stable_top(v: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest entries per row; equal values keep
    their order (the first occurrence first), as ``lax.top_k`` does."""
    return torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]


def _by_column(vals: torch.Tensor, idx: torch.Tensor):
    """Reorder each row's selection into ascending column order (the
    columns of a row are distinct, so the order is unique)."""
    order = torch.argsort(idx, dim=1)
    return (torch.take_along_dim(vals, order, dim=1).float(),
            torch.take_along_dim(idx, order, dim=1).to(torch.int32))


# --------------------------------------------------------- exact selection
def topk_select_exact(cand_v: torch.Tensor, cand_c: torch.Tensor, k: int):
    """Select k candidates per row under (value desc, col asc) whatever the
    candidates' order, in the reference's two passes: the first finds the
    k-th value ``v*``; the second ranks a composite key (+inf for sure
    winners, ``-col`` for the ties at ``v*``, -inf otherwise), so the tie
    slots fill with the smallest columns. Columns must be exact in f32
    (``SELECT_EXACT_MAX_N``)."""
    top = torch.take_along_dim(cand_v, _stable_top(cand_v, k), dim=1)
    vstar = top.amin(dim=1, keepdim=True)
    key = torch.where(
        cand_v > vstar, float("inf"),
        torch.where(cand_v == vstar, -cand_c.float(), NEG_INF))
    pos = _stable_top(key, k)
    return (torch.take_along_dim(cand_v, pos, dim=1),
            torch.take_along_dim(cand_c, pos, dim=1))


# ----------------------------------------------------------- reference scan
def _block_similarity(xr: torch.Tensor, xc: torch.Tensor,
                      metric: str) -> torch.Tensor:
    if metric == "neg_sqeuclidean":
        return similarity.neg_sqeuclidean(xr, xc)
    return _METRICS[metric](xr, xc)


def scan_topk(x: torch.Tensor, y: torch.Tensor, k: int,
              block: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], *,
              block_rows: int, block_cols: int, row_offset: int = 0):
    """The tiled scan every reference-style build shares: ``block(rows,
    cols)`` gives a similarity tile; tiles arrive in ascending column
    order and are merged into the running top-k by a stable sort of
    (carry ++ tile), so ties resolve to the smaller column. Diagonal
    entries (global row ``row_offset + i`` == column) are -inf and never
    enter unless a row has fewer than k other columns."""
    m, n = x.shape[0], y.shape[0]
    _check_k(k, n)
    br, bc = min(block_rows, m), min(block_cols, n)
    dev = x.device
    vals_out = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx_out = torch.empty((m, k), dtype=torch.int32, device=dev)
    for r0 in range(0, m, br):
        tile = x[r0:r0 + br]
        rows = row_offset + r0 + torch.arange(tile.shape[0], device=dev)
        vals = torch.full((tile.shape[0], k), NEG_INF, device=dev)
        idx = torch.zeros((tile.shape[0], k), dtype=torch.int64, device=dev)
        for c0 in range(0, n, bc):
            cols = c0 + torch.arange(min(bc, n - c0), device=dev)
            s = block(tile, y[c0:c0 + bc]).float()
            s = torch.where(cols[None, :] == rows[:, None], NEG_INF, s)
            cand_v = torch.cat([vals, s], dim=1)
            cand_i = torch.cat([idx, cols.expand(tile.shape[0], -1)], dim=1)
            pos = _stable_top(cand_v, k)
            vals = torch.take_along_dim(cand_v, pos, dim=1)
            idx = torch.take_along_dim(cand_i, pos, dim=1)
        vals_out[r0:r0 + br], idx_out[r0:r0 + br] = _by_column(vals, idx)
    return vals_out, idx_out


def topk_similarity(x: torch.Tensor, k: int, *,
                    metric: str = "neg_sqeuclidean", block_rows: int = 1024,
                    block_cols: int = 4096,
                    cols: Optional[torch.Tensor] = None, row_offset: int = 0):
    """(M, d) row points -> (vals (M, k), idx (M, k)) off-diagonal top-k.

    ``cols`` (default: ``x`` itself) is the column point set; with a row
    shard plus the full set, ``row_offset`` is the shard's first global
    row, so self-edges mask correctly. ``k`` must lie in [1, N - 1]
    against the column count N; at ``k = N - 1`` the output is the whole
    off-diagonal similarity set.
    """
    y = x if cols is None else cols
    return scan_topk(x, y, k, lambda a, b: _block_similarity(a, b, metric),
                     block_rows=block_rows, block_cols=block_cols,
                     row_offset=row_offset)


# -------------------------------------------------------------- from dense
def topk_from_dense(s: torch.Tensor, k: int):
    """Compress a dense (N, N) similarity matrix to the top-k layout
    (diagonal excluded: it is the preference slot), under the same
    (value desc, col asc) order as every build."""
    n = s.shape[-1]
    _check_k(k, n)
    eye = torch.eye(n, dtype=torch.bool, device=s.device)
    off = torch.where(eye, NEG_INF, s)
    idx = _stable_top(off, k)
    return _by_column(torch.take_along_dim(off, idx, dim=1), idx)
