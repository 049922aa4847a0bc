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
into a running per-row top-k. ``topk_similarity_twostage`` is the
threshold-gated merge: points are kd-ordered into width-``chunk`` cells;
per row block, whole cells are gated on a lower distance bound against
the running k-th value, and only the surviving cells' candidates are
computed and merged through ``topk_select_exact``.

Both builds compute every similarity they keep in one fixed order, so
they select the same edges bit for bit on the CPU and on the card: the
dot product and the squared norms summed feature by feature in ascending
order, each product and sum rounded once, then ``(xx + yy) - 2 dot``
(``_ordered_tile``, ``_pair_values``). That is the arithmetic of the
similarity kernel (``csrc/similarity.cu``), which gives the scan its
neg-sqeuclidean tiles on the card, as the reference takes them from
``similarity_pallas`` on its accelerator. A matmul would not do: its
order and fused multiply-adds depend on the shapes and the library, and
the two-stage build gathers other shapes than the scan's tiles.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.similarity import _METRICS
from repro_torch.kernels import similarity
from repro_torch.sharding.partitioning import kd_median_cut

NEG_INF = float("-inf")

#: beyond this N the exact tie-break select (column ids embedded in f32
#: keys) would lose integer precision; the reference scan has no such cap.
SELECT_EXACT_MAX_N = 1 << 24

#: relative / absolute slack on the two-stage chunk bounds: the triangle
#: inequality is exact in reals but the centroid distances and radii are
#: f32, so the gate widens by a hair rather than ever pruning a true edge.
_GATE_REL = 1e-4
_GATE_ABS = 1e-6


def _check_metric(metric: str) -> None:
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}; known: "
                         f"{tuple(_METRICS)}")


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


# ------------------------------------------------- fixed-order arithmetic
def _dot_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcast (..., d) pairs -> (...): products summed over features in
    ascending order, each product and sum rounded once."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    acc = torch.zeros(shape, dtype=torch.float32, device=a.device)
    for f in range(a.shape[-1]):
        acc = acc + a[..., f] * b[..., f]
    return acc


def _geometry(x: torch.Tensor, metric: str) -> torch.Tensor:
    """Map points into the space whose squared-Euclidean distances order
    the metric: identity for the (sq)euclidean metrics, per-point
    normalization for cosine (the norm summed in the fixed order). The
    two-stage bounds live in this space, and every similarity of the
    top-k builds is computed from it."""
    x = x.float()
    if metric == "cosine":
        return x / (torch.sqrt(_dot_in_order(x, x)) + 1e-12)[:, None]
    return x


def _survivor_values(d2: torch.Tensor, metric: str,
                     dot: torch.Tensor) -> torch.Tensor:
    """Metric values from the clamped squared distance ``d2`` in geometry
    space and the inner product ``dot`` (used by cosine), with the dense
    formulas of ``core.similarity``."""
    if metric == "neg_sqeuclidean":
        return -d2
    if metric == "neg_euclidean":
        return -torch.sqrt(d2.clamp_min(1e-12))
    return dot - 1.0


def _pair_values(dot: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor,
                 metric: str) -> torch.Tensor:
    """Similarities from fixed-order pieces: ``dot`` and the squared norms
    ``rr``, ``cc`` broadcast against it, ``d2 = (rr + cc) - 2 dot`` as in
    ``csrc/similarity.cu``."""
    d2 = ((rr + cc) - 2.0 * dot).clamp_min(0.0)
    return _survivor_values(d2, metric, dot)


def _ordered_tile(metric: str) -> Callable[[torch.Tensor, torch.Tensor],
                                           torch.Tensor]:
    """(m, d) x (n, d) geometry-space points -> (m, n) similarity tile in
    the fixed order; for neg-sqeuclidean the similarity kernel's value."""
    def tile(gr: torch.Tensor, gc: torch.Tensor) -> torch.Tensor:
        return _pair_values(_dot_in_order(gr[:, None, :], gc[None, :, :]),
                            _dot_in_order(gr, gr)[:, None],
                            _dot_in_order(gc, gc)[None, :], metric)
    return tile


# ----------------------------------------------------------- reference scan
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
    off-diagonal similarity set. Tiles: the similarity kernel for
    neg-sqeuclidean on the card, ``_ordered_tile`` otherwise.
    """
    _check_metric(metric)
    if metric == "neg_sqeuclidean" and x.device.type == "cuda":
        y, block = (x if cols is None else cols), similarity.neg_sqeuclidean
    else:
        x = _geometry(x, metric)
        y = x if cols is None else _geometry(cols, metric)
        block = _ordered_tile(metric)
    return scan_topk(x, y, k, block, block_rows=block_rows,
                     block_cols=block_cols, row_offset=row_offset)


# ------------------------------------------------------- two-stage build
def _any_on_host(live: torch.Tensor) -> bool:
    """Whether any row is still live: a host read (``host_copies.
    twostage_build``, with the kd ordering's copy of the points), which on
    the card waits for the device."""
    return bool(obs.to_host(live.any(), "twostage_build"))


def kd_order(x: np.ndarray, leaf: int) -> np.ndarray:
    """Recursive median-cut ordering: consecutive runs of ``leaf`` points
    form tight axis-aligned cells (``sharding.partitioning``). Any
    permutation is correctness-neutral; only the pruning power of the
    chunk bounds depends on it."""
    return kd_median_cut(x, leaf)[0]


def _d2_threshold(rm: torch.Tensor, metric: str) -> torch.Tensor:
    """Value-space running row minimum -> inclusive squared-distance gate
    (a candidate at squared distance above it can never enter the row's
    top-k, ties included)."""
    if metric == "neg_sqeuclidean":
        thr = -rm
    elif metric == "neg_euclidean":
        thr = rm * rm
    else:  # cosine: v = x.y - 1 = -d^2/2 on normalized points
        thr = -2.0 * rm
    return thr * (1.0 + _GATE_REL) + _GATE_ABS


def topk_similarity_twostage(
    x: torch.Tensor, k: int, *, metric: str = "neg_sqeuclidean",
    block_rows: int = 1024, chunk: int = 128, round_chunks: int = 32,
    max_rounds: int = 4, residual_chunks: int = 32,
    cols: Optional[torch.Tensor] = None, row_offset: int = 0,
    perm: Optional[np.ndarray] = None):
    """Threshold-gated two-stage top-k build: the same (vals, idx) as
    ``topk_similarity`` bit for bit, with far less work on clusterable
    data.

    The column points are kd-ordered into cells of ``chunk``; per block
    of ``block_rows`` rows, a bootstrap merges the nearest cells, up to
    ``max_rounds`` rounds merge the ``round_chunks`` live cells of
    tightest bound (a cell is live while its lower distance bound passes
    the gate of the row's running k-th value), and a residual sweep over
    slabs of ``residual_chunks`` cells merges whatever the cap left live,
    skipping a slab no row needs. ``perm`` overrides the kd ordering.
    """
    y = x if cols is None else cols
    n = int(y.shape[0])
    _check_k(k, n)
    _check_metric(metric)
    if n > SELECT_EXACT_MAX_N:
        raise ValueError(
            f"two-stage build supports N <= {SELECT_EXACT_MAX_N} (column "
            "ids must be exact in f32 tie-break keys); use the reference "
            f"build for N = {n}")
    chunk = max(min(chunk, n), 1)
    nch = -(-n // chunk)
    boot = min(max(2, -(-(k + 1) // chunk) + 1), nch)
    if perm is None:
        perm = kd_order(obs.to_host(y.detach(), "twostage_build").numpy(),
                        chunk)
    return _twostage(
        x, y, torch.as_tensor(perm, device=x.device).long(), row_offset,
        k=k, metric=metric, block_rows=min(block_rows, int(x.shape[0])),
        chunk=chunk, round_chunks=min(round_chunks, nch),
        max_rounds=max_rounds, residual_chunks=min(residual_chunks, nch),
        boot_chunks=boot)


def _twostage(x, y, perm, row_offset, *, k, metric, block_rows, chunk,
              round_chunks, max_rounds, residual_chunks, boot_chunks):
    dev = x.device
    m, n, cw = x.shape[0], y.shape[0], chunk
    inf = float("inf")

    # ---- cell structures over the kd-permuted column set
    nch = -(-n // cw)
    pad = nch * cw - n
    yp = torch.nn.functional.pad(_geometry(y, metric)[perm], (0, 0, 0, pad))
    gcol = torch.nn.functional.pad(perm, (0, pad), value=n)   # n: phantom
    valid = gcol < n
    yy = torch.where(valid, _dot_in_order(yp, yp), inf)
    ych = yp.reshape(nch, cw, -1)
    wch = valid.reshape(nch, cw)
    cnt = wch.sum(dim=1).clamp_min(1).float()
    cen = (ych * wch[:, :, None]).sum(dim=1) / cnt[:, None]
    rad = torch.sqrt(torch.where(wch, ((ych - cen[:, None, :]) ** 2).sum(2),
                                 0.0).amax(dim=1))
    rad = rad * (1.0 + _GATE_REL) + _GATE_ABS
    cen_sq = (cen * cen).sum(dim=1)
    ccol, yych = gcol.reshape(nch, cw), yy.reshape(nch, cw)

    gx = _geometry(x, metric)
    vals_out = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx_out = torch.empty((m, k), dtype=torch.int32, device=dev)
    for r0 in range(0, m, block_rows):
        tile = gx[r0:r0 + block_rows]
        b = tile.shape[0]
        rows = row_offset + r0 + torch.arange(b, device=dev)
        txx = _dot_in_order(tile, tile)[:, None]
        d2c = (txx + cen_sq[None, :] - 2.0 * (tile @ cen.T)).clamp_min(0.0)
        # squared lower bound on the distance to anything in the cell
        lbd2 = ((torch.sqrt(d2c) * (1.0 - _GATE_REL) - rad).clamp_min(0.0)
                ** 2)

        def select(vals, idx, sg, cols_, dead):
            return topk_select_exact(
                torch.cat([vals, torch.where(dead, NEG_INF, sg)], dim=1),
                torch.cat([idx, cols_], dim=1), k)

        def merge_cells(vals, idx, cid, ok=None):
            """Stage 2: gather the picked cells' points and fold their
            similarities into the carry."""
            sw = cid.shape[1] * cw
            dot = _dot_in_order(tile[:, None, None, :],
                                ych[cid]).reshape(b, sw)
            cols_ = ccol[cid].reshape(b, sw)
            sg = _pair_values(dot, txx, yych[cid].reshape(b, sw), metric)
            dead = (cols_ == rows[:, None]) | (cols_ >= n)
            if ok is not None:
                dead = dead | ~ok.repeat_interleave(cw, dim=1)
            return select(vals, idx, sg, cols_, dead)

        def live_cells(vals, done, c0=0, c1=nch):
            thr = _d2_threshold(vals.amin(dim=1), metric)
            return ~done[:, c0:c1] & (lbd2[:, c0:c1] <= thr[:, None])

        # bootstrap: the nearest cells seed the running top-k (any
        # achieved k-th value is a valid gate floor)
        bid = torch.topk(-d2c, boot_chunks, dim=1).indices
        vals = torch.full((b, k), NEG_INF, device=dev)
        idx = torch.zeros((b, k), dtype=torch.int64, device=dev)
        vals, idx = merge_cells(vals, idx, bid)
        done = torch.zeros((b, nch), dtype=torch.bool, device=dev)
        done.scatter_(1, bid, True)

        # stage 1 rounds: fold the tightest-bound live cells; every merge
        # raises the row minimum and shrinks the live set
        for _ in range(max_rounds):
            live = live_cells(vals, done)
            if not _any_on_host(live):
                break
            lv, cid = torch.topk(torch.where(live, -lbd2, NEG_INF),
                                 round_chunks, dim=1)
            # short rows pad their picks with dead cells: ok masks them
            vals, idx = merge_cells(vals, idx, cid, ok=lv > NEG_INF)
            done.scatter_(1, cid, True)

        # residual: contiguous slabs over whatever the cap left live,
        # skipped outright when no row of the block still needs one
        for c0 in range(0, nch, residual_chunks):
            c1 = min(c0 + residual_chunks, nch)
            live = live_cells(vals, done, c0, c1)
            if not _any_on_host(live):
                continue
            span = slice(c0 * cw, c1 * cw)
            cols_ = gcol[span][None, :].expand(b, -1)
            sg = _pair_values(_dot_in_order(tile[:, None, :],
                                            yp[span][None, :, :]),
                              txx, yy[span][None, :], metric)
            dead = ((cols_ == rows[:, None]) | (cols_ >= n)
                    | ~live.repeat_interleave(cw, dim=1))
            vals, idx = select(vals, idx, sg, cols_, dead)
        vals_out[r0:r0 + b], idx_out[r0:r0 + b] = _by_column(vals, idx)
    return vals_out, idx_out


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
