"""Synthetic point datasets mirroring the paper's evaluation data.

The paper's scaling experiment (§4.2) uses the "Aggregation" shape set
(Gionis et al., 788 2-D points, 7 clusters of varied size/shape). The
container has no network access, so ``aggregation_like`` procedurally
generates a same-spirit shape set: 7 clusters, 788 points, mixed blob
shapes and sizes, with ground-truth labels for purity scoring.

A copy of ``repro/data/synth.py``; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import numpy as np


def gaussian_blobs(
    n: int = 788, k: int = 7, dim: int = 2, seed: int = 0,
    spread: float = 0.6, box: float = 10.0,
) -> tuple[np.ndarray, np.ndarray]:
    """k isotropic Gaussian clusters with uneven sizes."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, box, size=(k, dim))
    weights = rng.dirichlet(np.full(k, 3.0))
    counts = np.maximum(1, (weights * n).astype(int))
    counts[-1] += n - counts.sum()
    pts, labels = [], []
    for c in range(k):
        pts.append(centers[c] + spread * rng.standard_normal((counts[c], dim)))
        labels.append(np.full(counts[c], c))
    return np.concatenate(pts).astype(np.float32), np.concatenate(labels)


def aggregation_like(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """788 2-D points in 7 clusters of varied shape (Aggregation analogue)."""
    rng = np.random.default_rng(seed)
    spec = [  # (count, center, (sx, sy), rot)
        (170, (7.0, 22.0), (2.2, 1.6), 0.3),   # big round blob
        (130, (20.0, 23.0), (2.6, 1.2), -0.4),  # elongated blob
        (100, (31.0, 22.0), (1.4, 1.4), 0.0),   # compact blob
        (138, (11.0, 8.0), (3.0, 1.0), 0.9),    # tilted ellipse
        (120, (24.0, 7.0), (1.8, 1.8), 0.0),    # round
        (80, (33.0, 9.0), (1.0, 2.0), 0.0),     # tall
        (50, (17.0, 15.0), (0.7, 0.7), 0.0),    # small bridge cluster
    ]
    pts, labels = [], []
    for idx, (cnt, ctr, (sx, sy), rot) in enumerate(spec):
        p = rng.standard_normal((cnt, 2)) * np.array([sx, sy])
        rotm = np.array([[np.cos(rot), -np.sin(rot)],
                         [np.sin(rot), np.cos(rot)]])
        pts.append(p @ rotm.T + np.array(ctr))
        labels.append(np.full(cnt, idx))
    x = np.concatenate(pts).astype(np.float32)
    y = np.concatenate(labels)
    assert x.shape == (788, 2)
    return x, y


def two_moons(n: int = 512, seed: int = 0, noise: float = 0.08
              ) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    n1 = n // 2
    t1 = rng.uniform(0, np.pi, n1)
    t2 = rng.uniform(0, np.pi, n - n1)
    m1 = np.stack([np.cos(t1), np.sin(t1)], axis=1)
    m2 = np.stack([1.0 - np.cos(t2), 0.5 - np.sin(t2)], axis=1)
    x = np.concatenate([m1, m2]) + noise * rng.standard_normal((n, 2))
    y = np.concatenate([np.zeros(n1, int), np.ones(n - n1, int)])
    return x.astype(np.float32), y
