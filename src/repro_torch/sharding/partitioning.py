"""Partitioning helpers (port of ``repro/sharding/partitioning.py`` and
of the mesh context of ``repro/sharding/compat.py``; the port imports
nothing of ``repro``).

Mesh side: the spec type ``P``; ``filter_spec`` projects a logical spec
onto the axes a mesh has, ``shape_safe_shardings`` also drops what a
leaf cannot divide, and a ``Sharding`` (a mesh plus a spec) gives this
rank's block of a leaf and gathers blocks back. ``set_mesh`` puts a mesh
in context for what reads it (``maybe_shard``, the MoE's dispatch);
``AbstractMesh`` has axis sizes and no ranks, for the dry run. The
reference's ``shard_map`` and ``pvary`` have no counterpart: the port
issues its collectives explicitly (``sharding.dist``).

Data side: the kd median-cut partitioner and ``row_block``, the
counterpart of the reference's ``device_put_row_sharded``. The
partitioner is shared by the two-stage top-k build (which uses the
*ordering*: consecutive runs form tight cells for its pruning gate) and
the ``coarsen`` solver backend (which uses the *cells* as its local-solve
partitions). Host-side numpy on purpose: partitioning is
correctness-neutral for both consumers, only pruning power and partition
locality depend on it.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, NamedTuple

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


# ------------------------------------------------------------ mesh specs
# Logical specs (``P``: per dim None, an axis name or a tuple of axis
# names) are written against the largest mesh,
# ("pod", "data", "model"); ``filter_spec`` projects them onto the mesh
# at hand. A mesh here is anything with ``axis_names`` and ``shape`` (axis
# name -> size): a ``launch.mesh.WorkerMesh`` over the ranks of a group,
# or an ``AbstractMesh``, which has sizes and no ranks.

class P(tuple):
    """Logical sharding of one leaf: per dim the logical mesh axis it
    shards over (``"model"``, ``"data"``, a tuple of axes) or None — the
    reference's ``PartitionSpec`` as a plain tuple."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> tuple:
    """A spec entry as a tuple of axis names (None -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes: tuple):
    """The inverse of ``_axes``: () -> None, a singleton -> the name."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def filter_spec(spec, axis_names):
    """Drop mesh axes that do not exist on the current mesh. A tuple left
    with one axis becomes that axis, so P(("a",)) and P("a") are one spec."""
    names = set(axis_names)
    return P(*(_entry(tuple(a for a in _axes(e) if a in names))
               for e in spec))


def _divisible_spec(spec, shape, mesh):
    """Drop sharding on dims the array cannot divide (batch 1 on a 32-way
    data axis, 8 KV heads on a 16-way model axis): per dim, keep the
    longest prefix of axes whose product divides the dim. Entries past the
    array's rank become None."""
    sizes = mesh.shape
    out = []
    for i, entry in enumerate(spec):
        if i >= len(shape):
            out.append(None)
            continue
        kept, prod = [], 1
        for a in _axes(entry):
            if shape[i] % (prod * sizes[a]):
                break
            kept.append(a)
            prod *= sizes[a]
        out.append(_entry(tuple(kept)))
    return P(*out)


class AbstractMesh:
    """Axis names and sizes without ranks (``jax.sharding.AbstractMesh``):
    what the dry run lays state out on for 256 and 512 devices that do
    not exist. ``empty`` when it has no axes. Its axes are rank 0's, and
    ``traffic`` counts the bytes their collectives would send."""

    def __init__(self, sizes: tuple, axis_names: tuple):
        if len(sizes) != len(axis_names):
            raise ValueError(f"mesh shape {sizes} does not fit axes "
                             f"{axis_names}")
        from repro_torch.sharding import dist
        self.sizes = tuple(int(s) for s in sizes)
        self.axis_names = tuple(axis_names)
        self.traffic = dist.Traffic()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def empty(self) -> bool:
        return not self.axis_names

    def axis(self, name: str):
        """The axis as rank 0 of the mesh sees it, with the ``"dry"``
        transport: collectives over it count bytes and move nothing."""
        from repro_torch.sharding import dist
        size = self.shape[name]
        return dist.Axis(name, size, 0, None, tuple(range(size)), "dry",
                         self.traffic)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def make_abstract_mesh(axis_shapes, axis_names) -> AbstractMesh:
    """``compat.make_abstract_mesh``: a mesh of these sizes and names."""
    return AbstractMesh(tuple(axis_shapes), tuple(axis_names))


_EMPTY = AbstractMesh((), ())
_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=_EMPTY)


def get_abstract_mesh():
    """The mesh that ``set_mesh`` put in context, or an empty mesh."""
    return _MESH.get()


@contextlib.contextmanager
def set_mesh(mesh):
    """Context manager putting ``mesh`` (a ``WorkerMesh`` or an
    ``AbstractMesh``) in context, as ``jax.set_mesh`` does; what reads it
    (``maybe_shard``, the MoE's dispatch) sees it until the block ends."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def maybe_shard(x, spec):
    """``with_sharding_constraint`` where a mesh is in context. A
    constraint places a value and never changes it; the port issues its
    collectives explicitly, so there is nothing to place: the identity."""
    return x


class Sharding(NamedTuple):
    """A mesh and a spec over it (``jax.sharding.NamedSharding``). A dim
    sharded over a tuple of axes splits over their product, the first
    axis major, as ``NamedSharding`` lays it out."""
    mesh: Any
    spec: Any

    def block_shape(self, shape) -> tuple:
        sizes = self.mesh.shape
        out = list(shape)
        for i, entry in enumerate(self.spec):
            n = math.prod(sizes[a] for a in _axes(entry))
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"over {_axes(entry)} ({n} ways)")
            out[i] //= n
        return tuple(out)

    def block(self, x) -> torch.Tensor:
        """This rank's block of the whole array ``x`` (numpy or torch; a
        contiguous tensor that shares nothing with ``x``)."""
        t = torch.as_tensor(np.asarray(x)) if isinstance(x, np.ndarray) \
            else x
        bshape = self.block_shape(t.shape)
        for i, entry in enumerate(self.spec):
            idx = 0
            for a in _axes(entry):
                ax = self.mesh.axis(a)
                idx = idx * ax.size + ax.index
            if bshape[i] != t.shape[i]:
                t = t.narrow(i, idx * bshape[i], bshape[i])
        return t.clone(memory_format=torch.contiguous_format)

    def gather(self, block: torch.Tensor, to_spec=()) -> torch.Tensor:
        """Undo the split of ``block`` over the axes this spec has beyond
        ``to_spec`` (per dim, ``to_spec``'s axes must be a prefix of this
        spec's; the default gathers the whole array): all-gathers along
        each such axis, the minor one first, on every rank."""
        from repro_torch.sharding.dist import all_gather
        for i, entry in enumerate(self.spec):
            axes = _axes(entry)
            keep = _axes(to_spec[i]) if i < len(to_spec) else ()
            if axes[:len(keep)] != keep:
                raise ValueError(f"{to_spec} is not a coarser layout of "
                                 f"{self.spec} in dim {i}")
            for a in reversed(axes[len(keep):]):
                block = all_gather(block, self.mesh.axis(a), axis=i)
        return block


def _is_spec(s) -> bool:
    return isinstance(s, P)


def tree_shardings(mesh, spec_tree: Any) -> Any:
    """Spec tree -> ``Sharding`` tree, axis-filtered for ``mesh``."""
    from repro_torch.models.layers.common import tree_map
    return tree_map(lambda s: Sharding(mesh, filter_spec(s, mesh.axis_names)),
                    spec_tree, is_leaf=_is_spec)


def shape_safe_shardings(mesh, shape_tree: Any, spec_tree: Any) -> Any:
    """``Sharding``s whose specs are both axis-filtered and
    shape-divisibility-safe for the leaves of ``shape_tree`` (anything
    with a ``shape``: tensors, meta tensors, numpy arrays)."""
    from repro_torch.models.layers.common import tree_map

    def one(s, leaf):
        spec = _divisible_spec(filter_spec(s, mesh.axis_names),
                               tuple(leaf.shape), mesh)
        return Sharding(mesh, spec)
    return tree_map(one, spec_tree, shape_tree, is_leaf=_is_spec)
