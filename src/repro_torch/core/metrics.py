"""Extrinsic/intrinsic cluster quality metrics (paper §4 uses purity);
copy of ``repro/core/metrics.py``."""
from __future__ import annotations

import numpy as np


def purity(labels: np.ndarray, truth: np.ndarray) -> float:
    """Purity = (1/N) * sum_clusters max_class |cluster ∩ class| (paper [18])."""
    labels = np.asarray(labels)
    truth = np.asarray(truth)
    total = 0
    for c in np.unique(labels):
        members = truth[labels == c]
        if members.size:
            total += np.bincount(members).max()
    return float(total) / float(labels.size)


def nmi(labels: np.ndarray, truth: np.ndarray) -> float:
    """Normalized mutual information (arith. mean normalization)."""
    labels = np.asarray(labels)
    truth = np.asarray(truth)
    n = labels.size
    _, li = np.unique(labels, return_inverse=True)
    _, ti = np.unique(truth, return_inverse=True)
    kl, kt = li.max() + 1, ti.max() + 1
    cont = np.zeros((kl, kt))
    np.add.at(cont, (li, ti), 1.0)
    pxy = cont / n
    px = pxy.sum(1, keepdims=True)
    py = pxy.sum(0, keepdims=True)
    nz = pxy > 0
    mi = float(np.sum(pxy[nz] * np.log(pxy[nz] / (px @ py)[nz])))
    hx = -float(np.sum(px[px > 0] * np.log(px[px > 0])))
    hy = -float(np.sum(py[py > 0] * np.log(py[py > 0])))
    if hx == 0.0 or hy == 0.0:
        return 1.0 if kl == kt == 1 else 0.0
    return mi / (0.5 * (hx + hy))


def cluster_sizes(labels: np.ndarray) -> np.ndarray:
    _, counts = np.unique(np.asarray(labels), return_counts=True)
    return counts
