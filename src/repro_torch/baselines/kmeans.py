"""K-means (Lloyd's) in PyTorch — the building block of the paper's HK-Means
comparison baseline, Mahout's MapReduce K-means (port of
``repro/baselines/kmeans.py``).

``kmeans`` runs on one device; ``kmeans_distributed`` gives each rank of a
``torch.distributed`` group a row block of the points and sums the
per-cluster sufficient statistics over the ranks every iteration — the
literal MapReduce formulation (map: assign and partial sums; reduce:
``psum``), as Mahout distributes one K-means iteration (paper §4.2).
``psum`` adds the ranks' partials in rank order, so every rank holds the
same centers bit for bit.

The per-cluster sums accumulate in float64 and the centers are rounded to
float32 once, after the division; the reference sums in float32 in its
matmul's order. A float32 sum depends on how the points are split over the
ranks, and a center that moves by an ulp can move a point on a near-tie
to another cluster for the rest of the run (seen at the 200,000 blobs);
float64 partial sums make MapReduce K-means agree with one process, as
the MapReduce formulation promises (``ROADMAP.md`` C3). The distances
stay float32 matmuls (the reference leaves them to XLA; with TF32 off
they round as float32 products). Tensors run on their own device; numpy
input goes to ``device`` (None means CUDA, and a missing CUDA raises).

The default initial centers are ``k`` distinct points drawn by
``torch.randperm`` on a CPU generator seeded from ``seed`` — the same on
the CPU and the card, but not the reference's ``jax.random.choice``
draw, which torch cannot reproduce (``ROADMAP.md`` C3). Pass
``init_centers`` to start both packages from the same centers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.sharding.dist import all_gather, psum
from repro_torch.sharding.partitioning import row_block
from repro_torch.solver.engine import as_points


class KMeansResult(NamedTuple):
    centers: torch.Tensor   # (k, d)
    labels: torch.Tensor    # (n,) int32
    inertia: torch.Tensor   # scalar


def _assign(x, centers):
    d2 = ((x * x).sum(1)[:, None] + (centers * centers).sum(1)[None, :]
          - 2.0 * x @ centers.T)
    return d2.argmin(1), d2.amin(1)


def _update(x, labels, k):
    """Per-cluster (sums, counts), both float64: (k, d), (k, 1)."""
    hot = torch.nn.functional.one_hot(labels, k).double()     # (n, k)
    return hot.T @ x.double(), hot.sum(0)[:, None]


def _step(centers, sums, counts):
    mean = (sums / counts.clamp_min(1)).to(centers.dtype)
    return torch.where(counts > 0, mean, centers)


def _init_centers(x, k: int, init_centers, seed: int) -> torch.Tensor:
    if init_centers is not None:
        return torch.as_tensor(init_centers, dtype=x.dtype).to(x.device)
    gen = torch.Generator().manual_seed(int(seed))
    idx = torch.randperm(x.shape[0], generator=gen)[:k]
    return x[idx.to(x.device)]


def kmeans(x, k: int, *, iterations: int = 25, init_centers=None,
           seed: int = 0, device: Optional[str] = None) -> KMeansResult:
    """``iterations`` Lloyd steps from ``init_centers`` (default: ``k``
    distinct points drawn from ``seed``); an empty cluster keeps its
    center."""
    x = as_points(x, device)
    centers = _init_centers(x, k, init_centers, seed)
    for _ in range(iterations):
        labels, _ = _assign(x, centers)
        centers = _step(centers, *_update(x, labels, k))
    labels, d2 = _assign(x, centers)
    return KMeansResult(centers, labels.to(torch.int32), d2.sum())


def kmeans_distributed(x, k: int, mesh, *, iterations: int = 25,
                       init_centers=None, seed: int = 0,
                       axis_name: str = "workers",
                       device: Optional[str] = None) -> KMeansResult:
    """MapReduce K-means: every rank passes all N points and works on its
    row block of ``mesh[axis_name]``; centers stay replicated, and each
    iteration ``psum``s (sums, counts) over the ranks — Mahout's scheme.
    Labels come back for all N points on every rank."""
    x = as_points(x, device)
    n = x.shape[0]
    workers = mesh.shape[axis_name]
    if n % workers:
        raise ValueError(f"N={n} must divide workers={workers}")
    ax = mesh.axis(axis_name)
    centers = _init_centers(x, k, init_centers, seed)
    x_loc = row_block(x, mesh, axis_name)
    for _ in range(iterations):
        labels, _ = _assign(x_loc, centers)
        sums, counts = _update(x_loc, labels, k)
        centers = _step(centers, psum(sums, ax), psum(counts, ax))  # reduce
    labels, d2 = _assign(x_loc, centers)
    return KMeansResult(centers, all_gather(labels.to(torch.int32), ax),
                        psum(d2.sum(), ax))
