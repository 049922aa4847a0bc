"""k isotropic Gaussian clusters of uneven sizes in a box: a frozen copy
of the repository's ``data/synth.py`` ``gaussian_blobs`` (the paper's
scaling data, ``benchmarks/bench_scaling.py``), kept here so that a change
there does not move the benchmark's inputs."""
from __future__ import annotations

import numpy as np


def gaussian_blobs(n: int, k: int, dim: int, seed: int, spread: float,
                   box: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, box, size=(k, dim))
    weights = rng.dirichlet(np.full(k, 3.0))
    counts = np.maximum(1, (weights * n).astype(int))
    counts[-1] += n - counts.sum()
    pts = [centers[c] + spread * rng.standard_normal((counts[c], dim))
           for c in range(k)]
    return np.concatenate(pts).astype(np.float32)


def make(params: dict, seed: int) -> np.ndarray:
    return gaussian_blobs(params["n"], params["clusters"], params["dim"],
                          seed, params["spread"], params["box"])
