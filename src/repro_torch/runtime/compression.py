"""Gradient compression for the data-parallel all-reduce (port of
``repro/runtime/compression.py``).

Top-k sparsification with *local* magnitude selection: each leaf keeps its
largest-|g| ``ratio`` fraction and zeroes the rest, so a later all-reduce
moves a sparse tensor. Deterministic and stateless; classic error feedback
(carrying the residual) is an explicit variant for a training loop that
owns persistent compressor state.

The threshold is the reference's: k = max(1, int(n * ratio)), the k-th
largest |g| from ``torch.topk`` on the leaf's own device (the reference
leaves its ``jax.lax.top_k`` to XLA), and every entry with |g| >= it is
kept, so ties at the threshold keep more than k. The k-th largest value
does not depend on how ``torch.topk`` orders ties, so the mask equals the
reference's on the same input.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.layers.common import tree_map


def topk_compress(g: torch.Tensor, ratio: float) -> torch.Tensor:
    """Keep the top max(1, int(ratio * n)) entries by |value| (and any
    tied with the last of them), zero the rest."""
    if g.dim() == 0:
        return g
    mag = g.abs()
    k = max(1, int(g.numel() * ratio))
    thresh = torch.topk(mag.reshape(-1), k).values[-1]
    return torch.where(mag >= thresh, g, torch.zeros_like(g))


def compress_tree_grads(grads: Any, ratio: float = 0.01,
                        min_size: int = 65536) -> Any:
    """Compress only large leaves (small ones aren't worth the top-k)."""
    return tree_map(
        lambda g: topk_compress(g, ratio) if g.numel() >= min_size else g,
        grads)


def topk_with_error_feedback(
    g: torch.Tensor, residual: torch.Tensor, ratio: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """EF-SGD style: compress (g + residual), carry what was dropped."""
    corrected = g + residual
    sent = topk_compress(corrected, ratio)
    return sent, corrected - sent
