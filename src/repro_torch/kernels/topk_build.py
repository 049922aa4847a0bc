"""Fused top-k similarity build: CUDA kernel and plain version.

Replaces ``src/repro/kernels/topk_build_fused.py:topk_similarity_fused``.
The kernel is ``csrc/topk_build.cu``: it computes every neg-sqeuclidean
similarity with the arithmetic of ``csrc/similarity.cu`` and folds it into
a per-row running top-k kept sorted in shared memory, never writing the
(N, N) matrix. Bound by its FP32 operations: n^2 (2d + 5) for the pairs
(the dot, the distance formula, the gate's compare) and 2nd for the norms.
Its output rows are sorted by (value desc, col asc); the wrapper reorders
them by column with a sort after the kernel, as the reference argsorts
outside its ``pallas_call``.

``plain`` is the reference scan over tiles of ``ref.neg_sqeuclidean`` with
a stable-sort merge. ``in_kernel_order`` is the same scan with the tiles'
dot products and norms summed feature by feature, the kernel's order, so
the kernel must equal it bit for bit; against ``plain`` (a matmul) values
differ within ``similarity.tolerance`` and the selected columns only where
a row's k-th and (k+1)-th values lie that close.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, check_operands, on_cpu, ref, stream_of
from repro_torch.kernels.topk_similarity import _by_column, _check_k, scan_topk

launches = 0

#: Tile shape of ``plain`` and ``in_kernel_order`` (the reference scan's).
BLOCK_ROWS, BLOCK_COLS = 1024, 4096


def plain(x: torch.Tensor, k: int):
    """(N, d) points -> (vals (N, k), idx (N, k)) by the reference scan
    over ``ref.neg_sqeuclidean`` tiles."""
    return scan_topk(x, x, k, ref.neg_sqeuclidean, block_rows=BLOCK_ROWS,
                     block_cols=BLOCK_COLS)


def _similarity_in_kernel_order(x: torch.Tensor,
                                y: torch.Tensor) -> torch.Tensor:
    """``ref.neg_sqeuclidean`` with the dot product and both norms summed
    over features in ascending order, each product and sum rounded."""
    x, y = x.float(), y.float()
    acc = torch.zeros((x.shape[0], y.shape[0]), device=x.device)
    xx = torch.zeros(x.shape[0], device=x.device)
    yy = torch.zeros(y.shape[0], device=x.device)
    for f in range(x.shape[1]):
        acc = acc + x[:, f, None] * y[None, :, f]
        xx = xx + x[:, f] * x[:, f]
        yy = yy + y[:, f] * y[:, f]
    return -((xx[:, None] + yy[None, :]) - 2.0 * acc).clamp_min(0.0)


def in_kernel_order(x: torch.Tensor, k: int):
    """``plain`` with the kernel's summation order; the kernel must equal
    it bit for bit."""
    return scan_topk(x, x, k, _similarity_in_kernel_order,
                     block_rows=BLOCK_ROWS, block_cols=BLOCK_COLS)


def topk_similarity_fused(x: torch.Tensor, k: int):
    """(N, d) points -> (vals (N, k) f32, idx (N, k) i32): each row's k
    largest off-diagonal neg-sqeuclidean similarities, columns ascending,
    ties to the smaller column."""
    global launches
    n, d = x.shape
    _check_k(k, n)
    if on_cpu("topk_build", x):
        return plain(x, k)
    check_operands("topk_build", x=(x, (n, d)))
    if n >= 2 ** 31:
        raise ValueError(f"topk_build: N = {n} exceeds the kernel's int32 "
                         "column ids")
    vals = torch.empty((n, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=x.device)
    norms = torch.empty(n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().repro_topk_build(
            x.data_ptr(), norms.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            n, d, k, stream_of(x))
    _build.check(err, "topk_build")
    launches += 1
    return _by_column(vals, idx)


def tolerance(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bound on |kernel - plain| of each selected value (row i, column
    ``idx[i, q]``): ``similarity.tolerance`` of that pair."""
    eps = 2.0 ** -24
    xx = (x.float() * x.float()).sum(dim=1)
    return 2 * (x.shape[1] + 2) * eps * (xx[:, None] + xx[idx.long()])


def compare_with_plain(x: torch.Tensor, k: int, vals: torch.Tensor,
                       idx: torch.Tensor) -> dict:
    """Hold a build's (vals, idx) against ``plain``. ``tol`` is a row's
    largest ``tolerance`` over plain's k + 1 best columns. In a row whose
    k-th and (k+1)-th plain values lie more than ``2 tol`` apart, the
    columns must be equal and each sorted value within ``tol``; in the
    other rows the two roundings may rank the near-tie apart, so the
    sorted values must lie within ``3 tol`` (the gap plus one rounding)."""
    n = x.shape[0]
    kp = min(k + 1, n - 1)
    pv1, pi1 = plain(x, kp)
    order = torch.sort(pv1, dim=1, descending=True, stable=True).indices
    ranked = torch.take_along_dim(pv1, order, dim=1)
    pv, pi = _by_column(ranked[:, :k], torch.take_along_dim(pi1, order,
                                                            dim=1)[:, :k])
    tol = tolerance(x, pi1).amax(dim=1)
    clear = torch.ones(n, dtype=torch.bool, device=x.device)
    if kp > k:
        clear = (ranked[:, k - 1] - ranked[:, k]) > 2 * tol
    bound = torch.where(clear, tol, 3 * tol)[:, None]
    err = (torch.sort(vals, dim=1, descending=True).values
           - torch.sort(pv, dim=1, descending=True).values).abs()
    idx_rows = (idx != pi).any(dim=1)
    return {"max_abs_err": float(err.max()),
            "values_within_tolerance": bool((err <= bound).all()),
            "rows_near_tie": int((~clear).sum()),
            "idx_rows_differ": int(idx_rows.sum()),
            "idx_equal_off_ties": not bool((idx_rows & clear).any()),
            "bit_identical": bool(torch.equal(vals, pv)
                                  and torch.equal(idx, pi))}
