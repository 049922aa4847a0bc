"""Forward flash attention: CUDA kernel and plain version.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention_pallas``.
The kernel is ``csrc/flash_attention.cu``: one block of 4 warps per (bh,
``block_q`` query rows) walks the key/value tiles of ``block_k`` rows,
staged in the inputs' dtype by ``cp.async`` into a 2-stage ring, with an
online softmax on the tensor cores (``mma.sync``), for f32 or bf16 inputs
(output in the inputs' dtype). Bound by its operations, ``operations()``:
4 D per unmasked (query, key) pair. Key columns >= Sk are masked
explicitly, so it computes ``ref.flash_attention`` at every shape,
including the two where the Pallas kernel does not: a non-causal call
with a ragged Sk (the wrapper raises) and a causal one with Sq > Sk and
a ragged Sk (the padded keys score 0 for the rows >= Sk).

Precision contract: scores, softmax state and the output accumulator are
f32, and the products keep the f32 ``tolerance()`` by splitting operands.
In bf16, q.k is exact and p is split into hi = bf16(p) and lo = bf16(p -
hi), so p.v costs two products (6 D tensor-core operations per pair). In
f32 every operand x of both products is split into big = tf32(x) and
small = tf32(x - big) (``cvt.rna`` rounding) and a.b is taken as
small.big + big.small + big.big ("3xTF32", 12 D operations per pair).
``in_kernel_precision`` reproduces these roundings on the CPU, and, with
``split=False``, the single-pass schemes that miss the tolerance.

``plain`` is the oracle ``ref.flash_attention``, chunked over BH so that
the (chunk, Sq, Sk) f32 scores stay near ``PLAIN_CHUNK_SCORES``.
"""
from __future__ import annotations

import math

import torch

from repro_torch import obs
from repro_torch.kernels import _build, on_cpu, ref, stream_of

#: Query rows per block, at least (``MIN_BQ`` in
#: ``csrc/flash_attention.cu``); per instance: ``block_q``.
BLOCK_Q = 64
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
    obs.count("launches.flash_attention")
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


def padded_d(d: int) -> int:
    """The head-dim bucket the kernel pads D to: 32, 64, 128 or 256."""
    return next(b for b in (32, 64, 128, MAX_D) if d <= b)


def block_q(d: int, dtype: torch.dtype) -> int:
    """Query rows per block (``Geom::BQ``): 128 for bf16 at D <= 64, where
    each warp takes 32 rows, else 64."""
    return 128 if dtype == torch.bfloat16 and padded_d(d) <= 64 else 64


def block_k(d: int, dtype: torch.dtype) -> int:
    """Key rows per staged tile (``Geom::BK``): 64, or 32 for f32 at
    D > 64, where two stages of 64 f32 rows would not fit shared memory
    at D = 256."""
    return 32 if dtype == torch.float32 and padded_d(d) > 64 else 64


def tensor_core_operations(bh: int, sq: int, sk: int, d: int, causal: bool,
                           dtype: torch.dtype) -> int:
    """The kernel's own tensor-core work per unmasked pair: 6 D in bf16
    (q.k once, p.v as hi and lo), 12 D in f32 (3xTF32 on both products,
    each at half the bf16 rate)."""
    per_pair = 6 * d if dtype == torch.bfloat16 else 12 * d
    return per_pair * unmasked_pairs(bh, sq, sk, causal)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the int32 view: round the 13 dropped
    mantissa bits to nearest, ties away from zero (finite x)."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def _split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = _tf32(x)
    return big, _tf32(x - big)


#: Bits below an f32 accumulator's last place that the tensor cores keep
#: when they align an ``mma.sync``'s products and its accumulator to the
#: largest of them; what falls below is dropped, and the sum is truncated
#: to f32. Fitted on the H100 against the kernel's outputs (PERF.md, PR 14).
MMA_ALIGN_BITS = 2


def _truncate_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32, rounding toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _mma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         align_bits: int | None) -> torch.Tensor:
    """c + a @ b as one ``mma.sync`` computes it, for c (BH, M, N) f32, a
    (BH, M, K) and b (BH, K, N) exact in bf16 or TF32: the K products are
    exact; they and c are aligned to the largest exponent among them with
    ``align_bits`` bits below f32's last place, truncated there, summed,
    and the sum truncated to f32. ``align_bits=None``: the exact sum,
    rounded to nearest."""
    terms = torch.cat([c.double()[:, :, None],
                       a.double()[..., None] * b.double()[:, None]], dim=2)
    if align_bits is None:
        return terms.sum(dim=2).float()
    top = terms.abs().amax(dim=2, keepdim=True)
    _, e = torch.frexp(top)
    quantum = torch.ldexp(torch.ones_like(top), e - (24 + align_bits))
    return _truncate_f32((torch.trunc(terms / quantum) * quantum).sum(dim=2))


def _mma_chain(c: torch.Tensor, terms: list, step: int,
               align_bits: int | None) -> torch.Tensor:
    """c += the sum over (a, b) in ``terms`` of a @ b, one ``_mma`` per
    ``step`` of the inner dimension and term, in the kernel's order: each
    step's terms in turn, then the next step."""
    for k0 in range(0, terms[0][0].shape[-1], step):
        for a, b in terms:
            c = _mma(c, a[..., k0:k0 + step], b[:, k0:k0 + step],
                     align_bits)
    return c


def _split_terms(a: torch.Tensor, b: torch.Tensor, bf16: bool,
                 split: bool) -> list:
    """The kernel's operand roundings of a @ b, as (a, b) terms in its mma
    order. bf16 (a is p in f32, b bf16-exact): hi.b + lo.b with hi =
    bf16(a), lo = bf16(a - hi). f32: 3xTF32, small.big + big.small +
    big.big. ``split=False``: the first rounding's product alone."""
    if bf16:
        hi = a.bfloat16().float()
        lo = [((a - hi).bfloat16().float(), b)] if split else []
        return [(hi, b)] + lo
    ab, asm = _split_tf32(a)
    bb, bs = _split_tf32(b)
    return [(asm, bb), (ab, bs), (ab, bb)] if split else [(ab, bb)]


def in_kernel_precision(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, split: bool = True,
                        align_bits: int | None = MMA_ALIGN_BITS,
                        ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, for the precision tests
    (never called on the main path): the online softmax over key tiles of
    ``block_k`` rows in the log2 domain, and both products as the
    kernel's chains of tensor-core steps (8 keys or dims a step in TF32,
    16 in bf16), each step rounded as ``_mma`` does, with the kernel's
    operand roundings (bf16: q.k exact, p as bf16 hi + lo; f32: 3xTF32 on
    both products). ``split=False`` keeps only the first term (p rounded
    to bf16 once; one TF32 pass), the schemes that miss ``tolerance()``;
    ``align_bits=None`` sums each step exactly and rounds to nearest, the
    model the kernel is held against to show what the truncation costs.
    The row sums and exp2 are PyTorch's (the kernel's ``ex2.approx``
    differs in the last place), so it is close to the kernel, not
    bit-equal. Runs on the CPU or the card, in f64 products: slow."""
    bf16 = q.dtype == torch.bfloat16
    bh, sq, d = q.shape
    sk = k.shape[1]
    dev = q.device
    step = 16 if bf16 else 8
    qf, kf, vf = q.float(), k.float(), v.float()
    kt = kf.transpose(1, 2)
    s_all = _mma_chain(torch.zeros(bh, sq, sk, device=dev),
                       [(qf, kt)] if bf16 else _split_terms(qf, kt, False,
                                                            split), step,
                       align_bits)
    if causal:
        rows = torch.arange(sq, device=dev)[:, None]
        s_all = torch.where(rows >= torch.arange(sk, device=dev)[None, :],
                            s_all, float("-inf"))
    scale = torch.tensor(math.log2(math.e) / math.sqrt(d),
                         dtype=torch.float32, device=dev)
    m = torch.full((bh, sq, 1), float("-inf"), device=dev)
    l = torch.zeros(bh, sq, 1, device=dev)
    acc = torch.zeros(bh, sq, d, device=dev)
    tile = block_k(d, q.dtype)
    for k0 in range(0, sk, tile):
        s = s_all[:, :, k0:k0 + tile]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale)
        safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp2(m - safe)
        p = torch.exp2((s.double() * scale.double() - safe.double()).float())
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = _mma_chain(acc * alpha,
                         _split_terms(p, vf[:, k0:k0 + tile], bf16, split),
                         step, align_bits)
        m = m_new
    out = torch.where(l == 0, 0.0, acc / torch.where(l == 0, 1.0, l))
    return out.to(q.dtype)
