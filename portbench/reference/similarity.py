"""Similarities, exact top-k lists and median preferences, in plain PyTorch.

The similarity of points i and j is the repository's float32 squared
distance, negated:

    s_ij = -max(0, (xx_i + xx_j) - 2 acc_ij),
    xx_i = sum_f x_if^2,  acc_ij = sum_f x_if x_jf,

both sums taken over the features in ascending order, each product and
each sum rounded once to float32 (no fused multiply-add). Every step below
is an elementwise op of its own, so each is rounded once, as stated. A
matrix product would sum in another order and round otherwise: on the
200,000 blobs that moves the top-k cut of most rows (the neighbours' d2
are small beside the norms), so it is used here only to find candidates,
in float64.

A top-k list is the k largest off-diagonal similarities of a row under
(value desc, column asc), stored with its columns ascending.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.precision import identity

_EPS32 = 2.0 ** -24


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """(N,) float32 squared norms, summed over features in order."""
    acc = x[:, 0] * x[:, 0]
    for f in range(1, x.shape[1]):
        acc = acc + x[:, f] * x[:, f]
    return acc


def _d2_pairs(xr: torch.Tensor, xxr: torch.Tensor, y: torch.Tensor,
              yy: torch.Tensor) -> torch.Tensor:
    """d2 of rows ``xr`` (B, d) against ``y``: (C, d) shared by every row,
    or (B, C, d) one set a row; ``yy`` the matching norms."""
    if y.dim() == 2:
        def col(f):
            return y[None, :, f]
        yyb = yy[None, :]
    else:
        def col(f):
            return y[:, :, f]
        yyb = yy
    acc = xr[:, 0, None] * col(0)
    for f in range(1, xr.shape[1]):
        acc = acc + xr[:, f, None] * col(f)
    return (xxr[:, None] + yyb) - 2.0 * acc


def _clamped(d2: torch.Tensor) -> torch.Tensor:
    """max(d2, 0) with a zero of positive sign, so that the float's bits
    order the values."""
    return torch.where(d2 > 0, d2, torch.zeros_like(d2))


def similarity_matrix(x: torch.Tensor, rnd=identity,
                      block: int = 2048) -> torch.Tensor:
    """(N, N) float32 similarities, diagonal 0, built a row block at a
    time; ``rnd`` rounds each block (the control's TF32)."""
    x = x.float()
    xx = sq_norms(x)
    n = x.shape[0]
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        out[r0:r1] = rnd(-_clamped(_d2_pairs(x[r0:r1], xx[r0:r1], x, xx)))
    out.fill_diagonal_(0.0)
    return out


def _keys(d2c: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys that order (d2 asc, column asc), i.e. (value desc,
    column asc), for d2 >= +0."""
    return (d2c.view(torch.int32).to(torch.int64) << 32) | cols.to(torch.int64)


def topk_lists(x: torch.Tensor, k: int, rnd=identity, block: int = 1024,
               margin: int = 64):
    """Exact top-k lists: ((N, k) float32 values, (N, k) int32 columns),
    columns ascending in each row, the diagonal left out.

    Candidates come from float64 distances (a matrix product); the
    float32 similarities above are then worked out for the candidates
    alone and the lists chosen from them. A row whose last candidate is
    not clearly past its k-th entry, by a bound on the float32 formula's
    rounding (and on ``rnd``'s), is worked out in full.
    """
    x = x.float()
    n, d = x.shape
    c = min(n - 1, k + margin)
    x64 = x.double()
    nrm64 = (x64 * x64).sum(1)
    cand = torch.empty((n, c), dtype=torch.int64, device=x.device)
    worst = torch.empty(n, dtype=torch.float64, device=x.device)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        d2 = nrm64[r0:r1, None] + nrm64[None, :] - 2.0 * (x64[r0:r1] @ x64.T)
        rows = torch.arange(r1 - r0, device=x.device)
        d2[rows, rows + r0] = float("inf")
        v, i = torch.topk(d2, c, dim=1, largest=False, sorted=True)
        cand[r0:r1], worst[r0:r1] = i, v[:, -1]
        del d2, v, i

    xx = sq_norms(x)
    vals = torch.empty((n, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((n, k), dtype=torch.int64, device=x.device)
    kth = torch.empty(n, dtype=torch.float32, device=x.device)
    chunk = max(1, (1 << 24) // max(1, c * d))
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        cc = cand[r0:r1]
        d2c = _clamped(rnd(_d2_pairs(x[r0:r1], xx[r0:r1], x[cc], xx[cc])))
        key = _keys(d2c, cc)
        top = torch.topk(key, k, dim=1, largest=False, sorted=True).indices
        kth[r0:r1] = torch.gather(d2c, 1, top[:, -1:])[:, 0]
        idx[r0:r1] = torch.gather(cc, 1, top)
        vals[r0:r1] = -torch.gather(d2c, 1, top)

    if c < n - 1:
        # |float32 formula - exact d2| <= (2d + 8) eps (xx + yy + 2|x||y|);
        # the control's rounding adds 2^-11 of the value at most
        m = float(xx.max())
        xxd = xx.double()
        tol = (2 * d + 8) * _EPS32 * (xxd + m + 2.0 * torch.sqrt(xxd * m))
        if rnd is not identity:
            tol = tol + 2.0 ** -10 * worst.abs()
        tol = tol + 1e-9 * (xxd + m)
        bad = torch.nonzero(worst - tol <= kth.double()).flatten().tolist()
        for i in bad:
            vi, ii = _full_row(x, xx, i, k, rnd)
            vals[i], idx[i] = vi, ii

    order = torch.argsort(idx, dim=1)
    idx = torch.gather(idx, 1, order)
    vals = torch.gather(vals, 1, order)
    return vals, idx.to(torch.int32)


def _full_row(x, xx, i: int, k: int, rnd):
    d2c = _clamped(rnd(_d2_pairs(x[i:i + 1], xx[i:i + 1], x, xx)))[0]
    d2c[i] = float("inf")
    cols = torch.arange(x.shape[0], device=x.device)
    top = torch.topk(_keys(d2c, cols), k, largest=False, sorted=True).indices
    return -d2c[top], top


def median_offdiag(s: torch.Tensor) -> torch.Tensor:
    """The mean of the two middle values of the off-diagonal entries of
    the square ``s`` (an even count), as a float32 scalar."""
    n = s.shape[0]
    off = s.reshape(-1)[1:].reshape(n - 1, n + 1)[:, :-1].reshape(-1)
    srt = torch.sort(off).values
    cnt = srt.numel()
    return 0.5 * (srt[(cnt - 1) // 2] + srt[cnt // 2])


def median_values(vals: torch.Tensor) -> torch.Tensor:
    """The mean of the two middle values of ``vals`` (all of them)."""
    srt = torch.sort(vals.reshape(-1)).values
    cnt = srt.numel()
    return 0.5 * (srt[(cnt - 1) // 2] + srt[cnt // 2])


def sample_rows(n: int, size: int, seed: int, fold: int) -> torch.Tensor:
    """The subsample the top-k path's median preference is estimated
    from: the first ``size`` of a ``torch.randperm(n)`` drawn on a CPU
    generator seeded from ``SeedSequence([seed, fold])``, as the
    configuration states."""
    state = np.random.SeedSequence([seed % 2 ** 64, fold])
    gen = torch.Generator().manual_seed(int(state.generate_state(1)[0]))
    return torch.randperm(n, generator=gen)[:size]
