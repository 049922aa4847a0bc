"""LR schedules (port of ``repro/train/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak: float = 3e-4, warmup: int = 100,
                  total: int = 10_000, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak``, then a cosine decay to ``floor * peak`` at
    ``total``; float32, from an integer step (a tensor stays on its
    device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
