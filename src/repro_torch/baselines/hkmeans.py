"""Hierarchical K-Means (HK-Means) — the paper's comparison baseline (§4.2):
Mahout's "Top Down" level-wise K-means, seeded by Canopy clustering (port
of ``repro/baselines/hkmeans.py``).

Top level first: canopy discovers k_top centers over all points (on the
host); each cluster is then recursively re-clustered for the next (finer)
level (K-means on ``device``). Labels are reported in the same (L, N)
orientation as HAP: level 0 = finest.

The top level is K-means from the canopy seeds, as in the reference. Each
sub-K-means draws its seed from the same numpy stream as the reference
(``rng.integers(0, 2**31)``), so the stream stays aligned, but seeds the
port's own initial-center draw with it (``kmeans``), not a jax key: the
lower levels differ from the reference's (``ROADMAP.md`` C3).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.baselines.canopy import auto_thresholds, canopy_centers
from repro_torch.baselines.kmeans import kmeans


class HKMeansResult(NamedTuple):
    labels: np.ndarray      # (L, N) dense cluster ids, level 0 = finest
    n_clusters: np.ndarray  # (L,)


def hierarchical_kmeans(
    x: np.ndarray, levels: int = 3, *, branch: int = 3, seed: int = 0,
    kmeans_iterations: int = 25, device: Optional[str] = None,
) -> HKMeansResult:
    """Top-down: canopy picks k at the top; every cluster splits into
    ``branch`` children per level going down. The K-means runs on
    ``device`` (None: CUDA, raising without a card)."""
    from repro_torch.solver.engine import resolve_device

    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n = len(x)
    t1, t2 = auto_thresholds(x, seed)
    seeds = canopy_centers(x, t1, t2, seed)
    k_top = max(2, len(seeds))

    # coarsest level
    xt = torch.from_numpy(x).to(dev)
    res = kmeans(xt, k_top, iterations=kmeans_iterations,
                 init_centers=torch.from_numpy(seeds).to(dev))
    labels_top = res.labels.cpu().numpy()

    all_labels = [labels_top]
    current = labels_top
    rng = np.random.default_rng(seed)
    for _ in range(levels - 1):
        nxt = np.zeros(n, np.int64)
        offset = 0
        for c in np.unique(current):
            idx = np.where(current == c)[0]
            k_c = min(branch, len(idx))
            if k_c <= 1:
                nxt[idx] = offset
                offset += 1
                continue
            sub = kmeans(xt[torch.from_numpy(idx).to(dev)], k_c,
                         iterations=kmeans_iterations,
                         seed=int(rng.integers(0, 2**31)))
            nxt[idx] = offset + sub.labels.cpu().numpy()
            offset += k_c
        all_labels.append(nxt)
        current = nxt

    # reorder: level 0 = finest (match HAP orientation)
    stack = np.stack(all_labels[::-1]).astype(np.int32)
    counts = np.array([len(np.unique(l)) for l in stack], np.int32)
    return HKMeansResult(stack, counts)
