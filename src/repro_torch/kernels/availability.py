"""Damped availability update (Eq 2.2/2.3): CUDA kernel and plain version.

Replaces ``src/repro/kernels/availability.py:availability_pallas``. The
kernel is ``csrc/availability.cu``: fixed-order column sums (no atomics,
re-runs are bit-identical), then one pass that emits the damped matrix —
bound by the bytes of three N x N matrices. Its column sums can differ
from ``plain`` by a few ulps (another summation order); everything else
rounds as ``plain`` does. ``in_kernel_order`` is ``plain`` with the
kernel's summation order, which the kernel must match bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.kernels import (
    _build, check_operands, on_cpu, ref, stream_of,
)

#: The plain PyTorch version.
plain = ref.availability

#: Rows per chunk of the kernel's column sums (``ROWS_PER_CHUNK`` in
#: ``csrc/availability.cu``).
ROWS_PER_CHUNK = 64


def availability(r: torch.Tensor, c: torch.Tensor, phi: torch.Tensor,
                 a_old: torch.Tensor, lam: float, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """r, a_old (N, N); c, phi (N,) -> damped alpha (N, N), written into
    ``out`` when given."""
    if on_cpu("availability", r, c, phi, a_old,
              *(() if out is None else (out,))):
        res = plain(r, c, phi, a_old, lam)
        return res if out is None else out.copy_(res)
    n = r.shape[0]
    if out is None:
        out = torch.empty((n, n), dtype=torch.float32, device=r.device)
    check_operands("availability", r=(r, (n, n)), c=(c, (n,)),
                   phi=(phi, (n,)), a_old=(a_old, (n, n)), out=(out, (n, n)))
    lib = _build.lib()
    scratch = torch.empty(lib.repro_availability_scratch(n),
                          dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = lib.repro_availability(
            r.data_ptr(), c.data_ptr(), phi.data_ptr(), a_old.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n, ctypes.c_float(lam),
            ctypes.c_float(1.0 - lam), stream_of(r))
    _build.check(err, "availability")
    obs.count("launches.availability")
    return out


def col_sums_in_kernel_order(r: torch.Tensor) -> torch.Tensor:
    """sum_{k != j} max(0, r_kj) in the kernel's order: each column
    sequentially within chunks of ``ROWS_PER_CHUNK`` rows, then the chunk
    partials in chunk order."""
    n = r.shape[-1]
    rp = torch.where(ref._eye(n, r.device), 0.0, r.float().clamp_min(0.0))
    pad = (-n) % ROWS_PER_CHUNK           # rows of zeros add nothing
    chunks = torch.nn.functional.pad(rp, (0, 0, 0, pad)).view(
        -1, ROWS_PER_CHUNK, n)
    partial = torch.zeros_like(chunks[:, 0])
    for k in range(ROWS_PER_CHUNK):
        partial = partial + chunks[:, k]
    col = torch.zeros_like(partial[0])
    for q in range(partial.shape[0]):
        col = col + partial[q]
    return col


def in_kernel_order(r: torch.Tensor, c: torch.Tensor, phi: torch.Tensor,
                    a_old: torch.Tensor, lam: float) -> torch.Tensor:
    """``plain`` with its column sums taken in the kernel's order; every
    other operation is ``plain``'s, so the kernel must equal this bit for
    bit."""
    eye = ref._eye(r.shape[-1], r.device)
    col = col_sums_in_kernel_order(r).unsqueeze(-2)
    rp = torch.where(eye, 0.0, r.float().clamp_min(0.0))
    base = (c.float() + phi.float()).unsqueeze(-2)
    a_off = (base + r.diagonal().unsqueeze(-2) + col - rp).clamp_max(0.0)
    new = torch.where(eye, base + col, a_off)
    return lam * a_old.float() + (1.0 - lam) * new


def tolerance(r: torch.Tensor, c: torch.Tensor, phi: torch.Tensor,
              lam: float, want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for one update, from the gap
    between the two column sums on these inputs.

    The kernel equals ``in_kernel_order`` (checked bit for bit on the
    card), which differs from ``plain`` only in its column sums. A gap d_j
    between them moves ``base + r_jj + col_j - max(0, r_ij)`` by d_j plus
    an ulp of each side's rounding; ``min(0, .)`` does not widen that,
    damping scales it by (1 - lam) with one more rounding, and the sum
    with ``lam * a_old`` rounds once more. The bound doubles each rounding.
    """
    eps = 2.0 ** -24
    col = ref.col_stats(r)[0]
    gap = (col_sums_in_kernel_order(r) - col).abs().unsqueeze(-2)
    rp = torch.where(ref._eye(r.shape[-1], r.device), 0.0,
                     r.float().clamp_min(0.0))
    off = ((c + phi).abs() + r.diagonal().abs() + col).unsqueeze(-2)
    return ((1.0 - lam) * (gap + 4 * eps * (off + rp + gap))
            + 4 * eps * want.abs())
