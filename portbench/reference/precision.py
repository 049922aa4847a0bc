"""Rounding to TF32, the precision the benchmark's control computes in.

TF32 keeps float32's exponent and 10 of its 23 mantissa bits. ``tf32``
rounds every finite float32 to the nearest TF32 value (ties to even) and
leaves infinities alone, so the reference run with it after each step is
the reference computed at TF32 precision.
"""
from __future__ import annotations

import torch

_DROP = 13                      # mantissa bits TF32 does not keep
_HALF = (1 << (_DROP - 1)) - 1  # 0xFFF: below half an ulp of TF32
_MASK = ~((1 << _DROP) - 1)


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32, round to nearest, ties to even."""
    b = t.contiguous().view(torch.int32)
    lsb = (b >> _DROP) & 1
    r = ((b + _HALF + lsb) & _MASK).view(torch.float32)
    return torch.where(torch.isfinite(t), r, t)


E4M3_MAX = 448.0


def e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to float8 e4m3 under one scale for the
    whole tensor (its largest magnitude maps to e4m3's largest value,
    448), round to nearest even, and scaled back: the rounding of a
    per-tensor scaled fp8 matrix product's inputs."""
    amax = t.abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return t
    scale = amax / E4M3_MAX
    q = (t / scale).clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)
    return q.to(torch.float32) * scale
