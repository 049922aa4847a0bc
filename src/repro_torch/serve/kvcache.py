"""Exemplar-compressed KV cache (port of ``repro/serve/kvcache.py``): the
paper's Affinity Propagation composed with the serving stack.

AP runs over the cached keys of a window and picks exemplars; the window
keeps only the exemplar entries, each exemplar's value replaced by the
mean of its cluster's values, and masks the rest (position -1) so that
attention skips them with the shapes unchanged. How many entries a window
keeps is data-dependent (AP has no preset k); the preference trades
memory for fidelity. This is flat AP (``core.affinity``), O(W^2) in the
window W, so it carries flat AP's float drift against the reference
(ROADMAP C2).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.affinity import affinity_propagation
from repro_torch.core.similarity import pairwise_similarity, set_preferences
from repro_torch.models.layers.attention import KVCache


class CompressionStats(NamedTuple):
    kept: torch.Tensor       # (B,) exemplar slots a row
    ratio: torch.Tensor      # kept / window


def exemplar_compress_window(
    k: torch.Tensor, v: torch.Tensor, *, preference: float,
    iterations: int = 50, damping: float = 0.7,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k, v: (W, K_heads, Dh) -> (k', v', keep (W,) bool).

    Exemplar rows keep their key and take their members' mean value;
    the other rows are zeroed and ``keep`` is False there."""
    w = k.shape[0]
    s = set_preferences(pairwise_similarity(k.reshape(w, -1).float()),
                        preference)
    e = affinity_propagation(s, iterations=iterations,
                             damping=damping).exemplars.long()
    keep = torch.zeros(w, dtype=torch.bool, device=k.device)
    keep[e] = True
    hot = F.one_hot(e, w).to(v.dtype)                  # member -> exemplar
    counts = hot.sum(0).clamp_min(1.0)
    vmean = (hot.T @ v.reshape(w, -1)) / counts[:, None]
    v_new = torch.where(keep[:, None], vmean, 0.0).reshape(v.shape)
    k_new = torch.where(keep[:, None], k.reshape(w, -1), 0.0).reshape(k.shape)
    return k_new, v_new, keep


def exemplar_compress_cache(
    cache: KVCache, *, window: int = 256, preference: float = -50.0,
    iterations: int = 50, damping: float = 0.7,
) -> tuple[KVCache, CompressionStats]:
    """Compress the oldest ``window`` entries of each row of a cache; the
    newest stay exact. Returns a new cache and the kept counts."""
    window = min(window, cache.k.shape[1])
    k2, v2, p2 = cache.k.clone(), cache.v.clone(), cache.pos.clone()
    kept = []
    for row in range(cache.k.shape[0]):
        k_new, v_new, keep = exemplar_compress_window(
            cache.k[row, :window].float(), cache.v[row, :window].float(),
            preference=preference, iterations=iterations, damping=damping)
        k2[row, :window] = k_new.to(k2.dtype)
        v2[row, :window] = v_new.to(v2.dtype)
        p2[row, :window] = torch.where(keep, cache.pos[row, :window], -1)
        kept.append(keep.sum())
    kept = torch.stack(kept)
    return (KVCache(k2, v2, p2, cache.length),
            CompressionStats(kept=kept, ratio=kept.float() / window))
