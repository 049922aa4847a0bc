"""Cluster-assignment post-processing (port of ``repro/core/assignments.py``;
numpy only, as the reference's host-side path is)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Hierarchy(NamedTuple):
    exemplars: np.ndarray   # (L, N) exemplar index per point per level
    labels: np.ndarray      # (L, N) dense cluster ids (0..k_l-1)
    n_clusters: np.ndarray  # (L,)
    parents: list           # parents[l][c] = cluster id at level l+1


def canonicalize(e: np.ndarray) -> np.ndarray:
    """Resolve one indirection: points follow their exemplar's exemplar."""
    e = np.asarray(e)
    return e[e]


def flatten_pointers(e: np.ndarray) -> np.ndarray:
    """Iterate ``e[e]`` to its fixed point (full pointer jumping)."""
    e = np.asarray(e)
    while True:
        e2 = e[e]
        if np.array_equal(e2, e):
            return e2
        e = e2


def dense_labels(e: np.ndarray) -> tuple[np.ndarray, int]:
    """Map exemplar indices to contiguous cluster ids."""
    uniq, inv = np.unique(np.asarray(e), return_inverse=True)
    return inv.astype(np.int32), int(uniq.size)


def canonicalize_levels(e: np.ndarray) -> np.ndarray:
    """Per-level canonicalize of an (L, N) exemplar array."""
    e = np.asarray(e)
    return np.stack([e[l][e[l]] for l in range(e.shape[0])])


def link_hierarchy(exemplars: np.ndarray) -> Hierarchy:
    """Build parent links: a level-l cluster's parent is the level-(l+1)
    cluster of its exemplar point (paper §2: tiered aggregation)."""
    e = canonicalize_levels(np.asarray(exemplars))
    levels = e.shape[0]
    labels = np.zeros_like(e)
    counts = np.zeros((levels,), np.int32)
    uniq_per_level = []
    for l in range(levels):
        labels[l], counts[l] = dense_labels(e[l])
        uniq_per_level.append(np.unique(e[l]))
    parents = [labels[l + 1][uniq_per_level[l]] for l in range(levels - 1)]
    return Hierarchy(e, labels, counts, parents)


def recolor_by_exemplar(values: np.ndarray, exemplars: np.ndarray) -> np.ndarray:
    """Paper §4.1: recolor every member with its exemplar's value (images)."""
    return np.asarray(values)[np.asarray(exemplars)]
