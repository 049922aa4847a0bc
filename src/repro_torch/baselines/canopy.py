"""Canopy clustering (McCallum et al.) — the paper seeds HK-Means with
Mahout's Canopy pass to discover the "natural" number of centers (§4)
(a copy of ``repro/baselines/canopy.py``: host numpy, the reference's
calls, so the same bits).

Greedy and inherently sequential; run on the host over a sample."""
from __future__ import annotations

import numpy as np


def canopy_centers(
    x: np.ndarray, t1: float, t2: float, seed: int = 0,
    max_canopies: int = 256,
) -> np.ndarray:
    """T1 > T2 loose/tight thresholds on Euclidean distance."""
    if not t1 >= t2 > 0:
        raise ValueError(f"canopy needs t1 >= t2 > 0; got t1={t1}, t2={t2}")
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float64)
    order = rng.permutation(len(x))
    remaining = list(order)
    centers = []
    while remaining and len(centers) < max_canopies:
        i = remaining[0]
        c = x[i]
        centers.append(c)
        d = np.linalg.norm(x[remaining] - c, axis=1)
        # points within T2 are removed from contention entirely
        remaining = [p for p, dist in zip(remaining, d) if dist > t2]
    return np.asarray(centers, np.float32)


def auto_thresholds(x: np.ndarray, seed: int = 0, sample: int = 256
                    ) -> tuple[float, float]:
    """Heuristic T1/T2 from a pairwise-distance sample (Mahout folklore:
    T1 ~ 1.5 x T2, T2 ~ mean pairwise distance / 3)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(x), min(sample, len(x)), replace=False)
    xs = np.asarray(x, np.float64)[idx]
    d = np.linalg.norm(xs[:, None] - xs[None, :], axis=-1)
    mean = float(d[np.triu_indices(len(xs), 1)].mean())
    t2 = mean / 3.0
    return 1.5 * t2, t2
