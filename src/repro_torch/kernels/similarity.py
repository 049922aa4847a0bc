"""Negative squared Euclidean similarity: CUDA kernel and plain version.

Replaces ``src/repro/kernels/similarity.py:similarity_pallas``. The kernel
is ``csrc/similarity.cu``: bound by the bytes of the (N, M) f32 output
(d is small), so each block stages a 16 x 256 tile's inputs in shared
memory, accumulates in registers with plain FP32 arithmetic (no TF32),
and writes every output row of the tile as one coalesced store.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import (
    _build, check_operands, on_cpu, ref, stream_of,
)

#: The plain PyTorch version (f32 accumulation, the reference's formula).
plain = ref.neg_sqeuclidean


def neg_sqeuclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (N, d), y (M, d) -> (N, M) negative squared distances."""
    if on_cpu("similarity", x, y):
        return plain(x, y)
    n, d = x.shape
    m = y.shape[0]
    check_operands("similarity", x=(x, (n, d)), y=(y, (m, d)))
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().repro_similarity(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), n, m, d,
            stream_of(x))
    _build.check(err, "similarity")
    obs.count("launches.similarity")
    return out


def tolerance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain|: each side sums d products
    and three norms' worth of terms in f32, so each lies within
    (d + 2) * eps * (|x_i|^2 + |y_j|^2) of the exact value. Integer inputs
    whose partial sums stay below 2**24 (pixels) are exact on both sides."""
    eps = 2.0 ** -24
    norms = (x * x).sum(dim=1)[:, None] + (y * y).sum(dim=1)[None, :]
    return 2 * (x.shape[1] + 2) * eps * norms

