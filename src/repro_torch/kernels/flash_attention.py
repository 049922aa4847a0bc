"""Forward flash attention: CUDA kernel and plain version.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention_pallas``.
The kernel is ``csrc/flash_attention.cu``: one block per (bh, 64 query
rows) walks the key/value tiles in shared memory with an online softmax,
in f32 on the CUDA cores, for f32 or bf16 inputs (output in the inputs'
dtype). Bound by its operations, ``operations()``: 4 D per unmasked
(query, key) pair. Key columns >= Sk are masked explicitly, so it
computes ``ref.flash_attention`` at every shape, including the two where
the Pallas kernel does not: a non-causal call with a ragged Sk (the
wrapper raises) and a causal one with Sq > Sk and a ragged Sk (the padded
keys score 0 for the rows >= Sk).

``plain`` is the oracle ``ref.flash_attention``, chunked over BH so that
the (chunk, Sq, Sk) f32 scores stay near ``PLAIN_CHUNK_SCORES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, on_cpu, ref, stream_of

launches = 0

#: Query rows per block and key rows per staged tile (``BQ``, ``BK`` in
#: ``csrc/flash_attention.cu``).
BLOCK_Q = BLOCK_K = 64
MAX_D = 256
DTYPES = (torch.float32, torch.bfloat16)
PLAIN_CHUNK_SCORES = 1 << 27

#: Elementwise tolerance of the kernel against ``plain`` in f32: the
#: reference's own test of its kernel against the oracle
#: (``tests/test_flash_attention.py``). Both sides accumulate in f32, in
#: other orders.
F32_ATOL = F32_RTOL = 2e-5


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          causal: bool = True) -> torch.Tensor:
    """``ref.flash_attention``, a chunk of BH at a time."""
    bh, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    step = max(1, PLAIN_CHUNK_SCORES // max(1, sq * sk))
    if step >= bh:
        return ref.flash_attention(q, k, v, causal)
    return torch.cat([ref.flash_attention(q[i:i + step], k[i:i + step],
                                          v[i:i + step], causal)
                      for i in range(0, bh, step)])


def _check_shapes(q, k, v) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: q, k, v must be (BH, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (BH, Sk, D) with q's "
                         f"BH = {bh} and D = {d}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (BH, Sq, D); k, v (BH, Sk, D) -> (BH, Sq, D) in q's dtype:
    ``softmax(q k^T / sqrt(D), causal row >= col) v``."""
    global launches
    _check_shapes(q, k, v)
    if on_cpu("flash_attention", q, k, v):
        return plain(q, k, v, causal)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16 on CUDA; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    bh, sq, d = q.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"flash_attention: head dim {d} outside "
                         f"[1, {MAX_D}]")
    if bh * -(-sq // BLOCK_Q) >= 2 ** 31:
        raise ValueError("flash_attention: BH * ceil(Sq / 64) must stay "
                         "below 2^31 blocks")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            k.shape[1], d, int(causal), int(q.dtype == torch.bfloat16),
            stream_of(q))
    _build.check(err, "flash_attention")
    launches += 1
    return out


def unmasked_pairs(bh: int, sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the function scores: row i sees min(i + 1, Sk)
    keys when causal, Sk otherwise."""
    if not causal:
        return bh * sq * sk
    m = min(sq, sk)
    return bh * (m * (m + 1) // 2 + max(0, sq - sk) * sk)


def operations(bh: int, sq: int, sk: int, d: int, causal: bool) -> int:
    """4 D operations per unmasked pair: the q.k products and sums and the
    p.v products and sums (the softmax's O(1) per pair is left out)."""
    return 4 * d * unmasked_pairs(bh, sq, sk, causal)


def nbytes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """q, k, v read once and o written once."""
    return q.element_size() * (2 * q.numel() + k.numel() + v.numel())


def tolerance(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for a ``plain`` output
    ``want``, in f32: ``F32_ATOL + F32_RTOL |want|``; for bf16 outputs one
    bf16 rounding step of |want| more (both sides round an f32 value that
    agrees within the f32 bound, so they may land one step apart)."""
    w = want.float().abs()
    tol = F32_ATOL + F32_RTOL * w
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(w)
        step = torch.ldexp(torch.ones_like(w), e - 8)
        tol = tol + torch.where(w > 0, step, 0.0)
    return tol
