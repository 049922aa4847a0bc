"""Plain PyTorch versions of the HAP kernels (port of ``repro/kernels/ref.py``).

They are the oracles the CUDA kernels are held against on the card, and
the path the kernel wrappers take for CPU tensors. Each follows the JAX
oracle's operation order, so on integer-valued inputs a kernel that
rounds the same way is bit-identical to its plain version.
"""
from __future__ import annotations

import math

import torch


def row_top2(v: torch.Tensor):
    """Per-row (max, argmax, second-max) over the last dimension.

    Ties: argmax is the first occurrence (``torch.argmax`` documents
    this); with a duplicated maximum the second max equals the max, since
    only the argmax position is masked out.
    """
    m1 = v.amax(dim=-1)
    i1 = v.argmax(dim=-1)
    masked = v.scatter(-1, i1.unsqueeze(-1), float("-inf"))
    m2 = masked.amax(dim=-1)
    return m1, i1.to(torch.int32), m2


def responsibility(s: torch.Tensor, a: torch.Tensor, tau: torch.Tensor,
                   r_old: torch.Tensor, lam: float) -> torch.Tensor:
    """Damped Eq 2.1: lam*r_old + (1-lam)*(s + min(tau, -max_{k!=j}(a+s)))."""
    sf = s.float()
    v = a.float() + sf
    m1, i1, m2 = row_top2(v)
    j = torch.arange(s.shape[-1], device=s.device)
    row_max = torch.where(j == i1.unsqueeze(-1), m2.unsqueeze(-1),
                          m1.unsqueeze(-1))
    new = sf + torch.minimum(tau.float().unsqueeze(-1), -row_max)
    return (lam * r_old.float() + (1.0 - lam) * new).to(s.dtype)


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


def col_stats(r: torch.Tensor):
    """(col_sum, diag): col_sum[j] = sum_{k != j} max(0, r_kj); diag[j]=r_jj."""
    rf = r.float()
    rp = torch.where(_eye(r.shape[-1], r.device), 0.0, rf.clamp_min(0.0))
    return rp.sum(dim=-2), rf.diagonal(dim1=-2, dim2=-1)


def availability(r: torch.Tensor, c: torch.Tensor, phi: torch.Tensor,
                 a_old: torch.Tensor, lam: float) -> torch.Tensor:
    """Damped Eq 2.2/2.3 from clamped column sums."""
    eye = _eye(r.shape[-1], r.device)
    col, rdiag = col_stats(r)
    rp = torch.where(eye, 0.0, r.float().clamp_min(0.0))
    base = (c.float() + phi.float()).unsqueeze(-2)
    a_off = (base + rdiag.unsqueeze(-2) + col.unsqueeze(-2) - rp).clamp_max(0.0)
    a_diag = base + col.unsqueeze(-2)
    new = torch.where(eye, a_diag, a_off)
    return (lam * a_old.float() + (1.0 - lam) * new).to(r.dtype)


def neg_sqeuclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """s_ij = -max(0, ||x_i||^2 + ||y_j||^2 - 2<x_i, y_j>) (f32 accumulation)."""
    xf, yf = x.float(), y.float()
    xx = (xf * xf).sum(dim=-1).unsqueeze(-1)
    yy = (yf * yf).sum(dim=-1).unsqueeze(-2)
    return (-(xx + yy - 2.0 * (xf @ yf.T)).clamp_min(0.0)).to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Oracle for the flash kernel: plain softmax attention in f32.
    q (BH, Sq, D); k, v (BH, Sk, D) -> (BH, Sq, D) in q's dtype. Causal is
    ``row >= col`` with both indices from 0; a row that sees no key gives
    0, not NaN."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = s.shape[-2:]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def off_diagonal(s: torch.Tensor) -> torch.Tensor:
    """The N*N - N off-diagonal entries of a square ``s``, row-major, 1-D.

    Dropping the first element of the flattened matrix leaves the diagonal
    at the end of every (N + 1)-wide row; no boolean mask is built.
    """
    n = s.shape[-1]
    return s.reshape(-1)[1:].reshape(n - 1, n + 1)[:, :-1].reshape(-1)


def middle_pair(x: torch.Tensor, *, skip_diagonal: bool) -> torch.Tensor:
    """Oracle for the median-select kernel: (lo, hi, 0.5 * (lo + hi)) of
    the values of ``x`` (its off-diagonal entries when ``skip_diagonal``),
    lo and hi the two middle order statistics by two ``kthvalue``
    selections (an even count's two middle values, an odd count's middle
    one twice)."""
    vals = off_diagonal(x) if skip_diagonal else x.reshape(-1)
    cnt = vals.numel()
    lo = torch.kthvalue(vals, (cnt - 1) // 2 + 1).values
    hi = torch.kthvalue(vals, cnt // 2 + 1).values
    return torch.stack([lo, hi, 0.5 * (lo + hi)])


#: The median-select kernel's digits, most significant first (bits).
SELECT_DIGITS = (11, 11, 10)


def radix_keys(v: torch.Tensor) -> torch.Tensor:
    """float32 -> uint32 keys (held in int64) whose order is the order
    ``torch.kthvalue`` ranks by: -0.0 as +0.0, every NaN above +inf."""
    b = v.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, 0, b)
    key = torch.where(b >= 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return torch.where(torch.isnan(v), 0xFFFFFFFF, key)


def key_values(keys: torch.Tensor) -> torch.Tensor:
    """The float32 values of ``radix_keys``' keys (NaN for a NaN's key)."""
    b = torch.where(keys >= 0x80000000, keys & 0x7FFFFFFF, ~keys & 0xFFFFFFFF)
    return ((b ^ 0x80000000) - 0x80000000).to(torch.int32).view(torch.float32)


def middle_pair_by_digits(x: torch.Tensor, *, skip_diagonal: bool):
    """The median-select kernel's walk in plain PyTorch: (lo, hi, mean).

    Each digit of ``SELECT_DIGITS`` is one pass: the histogram of the
    digit over the keys that match a rank's prefix so far (one histogram a
    distinct prefix, as the kernel keeps one a rank once the two differ),
    then the bin holding each rank extends its prefix, and the rank left
    inside the bin carries on. The mean rounds as ``middle_pair``'s.
    """
    vals = off_diagonal(x) if skip_diagonal else x.reshape(-1)
    keys = radix_keys(vals)
    cnt = keys.numel()
    ranks, prefixes, done = [(cnt - 1) // 2, cnt // 2], [0, 0], 0
    for bits in SELECT_DIGITS:
        shift = 32 - done - bits
        hists = {}
        for t in (0, 1):
            p = prefixes[t]
            if p not in hists:
                mine = keys[(keys >> (shift + bits)) == p]
                hists[p] = torch.bincount((mine >> shift) & ((1 << bits) - 1),
                                          minlength=1 << bits).cumsum(0)
            upto = hists[p]
            b = int(torch.searchsorted(upto, ranks[t], right=True))
            ranks[t] -= int(upto[b - 1]) if b else 0
            prefixes[t] = (p << bits) | b
        done += bits
    lo, hi = key_values(torch.tensor(prefixes, dtype=torch.int64))
    return torch.stack([lo, hi, 0.5 * (lo + hi)])
