"""kd median-cut point partitioning (a copy of ``kd_median_cut`` and
``kd_cells`` from ``repro/sharding/partitioning.py``; the port imports
nothing of ``repro``), and ``row_block``, the counterpart of the
reference's ``device_put_row_sharded``.

The partitioner is shared by the two-stage top-k build (which uses the
*ordering*: consecutive runs form tight cells for its pruning gate) and
the ``coarsen`` solver backend (which uses the *cells* as its local-solve
partitions). Host-side numpy on purpose: partitioning is
correctness-neutral for both consumers, only pruning power and partition
locality depend on it.
"""
from __future__ import annotations

import numpy as np
import torch


def kd_median_cut(x: np.ndarray, leaf: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Recursive median-cut partition of ``(N, d)`` points.

    Splits the widest axis-aligned dimension at its median until every
    cell holds at most ``leaf`` points. Returns ``(perm, splits)``:
    ``perm (N,)`` is the cut ordering (consecutive runs are tight cells)
    and ``splits (C+1,)`` are the cell boundaries, so cell ``c`` is
    ``perm[splits[c]:splits[c+1]]``. Cells are contiguous, disjoint,
    cover every point, and (for ``N > leaf``) hold at least ``leaf // 2``
    points each.
    """
    x = np.asarray(x, np.float32)
    if x.ndim != 2:
        raise ValueError(f"kd_median_cut needs (N, d) points; got {x.shape}")
    if leaf < 1:
        raise ValueError(f"leaf must be >= 1; got {leaf}")
    n = x.shape[0]
    perm = np.arange(n, dtype=np.int64)
    # LIFO with the left half pushed last -> leaves are visited (and cell
    # boundaries recorded) in left-to-right perm order
    stack = [(0, n)]
    bounds: list[int] = []
    while stack:
        lo, hi = stack.pop()
        if hi - lo <= leaf:
            bounds.append(lo)
            continue
        pts = x[perm[lo:hi]]
        dim = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        mid = (hi - lo) // 2
        part = np.argpartition(pts[:, dim], mid)
        perm[lo:hi] = perm[lo:hi][part]
        stack.append((lo + mid, hi))
        stack.append((lo, lo + mid))
    splits = np.asarray(bounds + [n], dtype=np.int64)
    return perm.astype(np.int32), splits


def kd_cells(x: np.ndarray, leaf: int) -> list[np.ndarray]:
    """Median-cut cells as index arrays, each sorted ascending, so that
    the downstream local solves do not depend on the cut's internal point
    order (and the single-cell case is exactly the identity ordering)."""
    perm, splits = kd_median_cut(x, leaf)
    return [np.sort(perm[splits[c]:splits[c + 1]])
            for c in range(len(splits) - 1)]


def row_block(x: torch.Tensor, mesh, axis_name: str, *,
              axis: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``axis`` over the mesh
    axis ``axis_name`` (the reference's ``device_put_row_sharded``: the
    layout every row-sharded program starts from). ``x.shape[axis]`` must
    split evenly."""
    ax = mesh.axis(axis_name)
    n = x.shape[axis]
    if n % ax.size:
        raise ValueError(f"{n} rows do not split over {ax.size} "
                         f"{axis_name}; pad them first")
    b = n // ax.size
    return x.narrow(axis, ax.index * b, b).contiguous()
