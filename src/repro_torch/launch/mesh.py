"""Worker meshes over the ranks of a ``torch.distributed`` group (port of
``repro/launch/mesh.py`` and of the ``make_mesh`` the engine builds its
2-D mesh with).

A mesh lays the first ``prod(shape)`` ranks of the default group out
row-major over named axes, as ``jax.make_mesh`` lays out devices. For each
axis this rank gets an ``Axis``: its coordinate and the process group of
the ranks that share every other coordinate, which the collectives of
``repro_torch.sharding.dist`` run over. Creating a group is a collective
call: every rank of the default group builds the same meshes in the same
order, members or not. Without a running group a mesh has one rank and
its collectives are identities.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as tdist

from repro_torch.sharding import dist


class WorkerMesh:
    """Axis names and sizes, this rank's coordinates, the groups and the
    transport; ``traffic`` counts the bytes this rank sent over any axis.
    ``member`` is False on a rank beyond the mesh's ranks."""

    def __init__(self, axis_names: tuple, sizes: tuple,
                 axes: Optional[dict], transport: str,
                 traffic: dist.Traffic):
        self.axis_names = axis_names
        self.sizes = sizes
        self._axes = axes
        self.transport = transport
        self.traffic = traffic

    @property
    def shape(self) -> dict:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def empty(self) -> bool:
        return not self.axis_names

    @property
    def member(self) -> bool:
        return self._axes is not None

    def axis(self, name: str) -> dist.Axis:
        if name not in self.axis_names:
            raise ValueError(f"mesh has no axis {name!r}; its axes are "
                             f"{self.axis_names}")
        if self._axes is None:
            raise ValueError(
                f"rank {dist.rank()} is not in this mesh of the first "
                f"{self.size} ranks")
        return self._axes[name]

    def __repr__(self) -> str:
        return (f"WorkerMesh({self.shape}, transport={self.transport!r}, "
                f"member={self.member})")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> WorkerMesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks, laid out
    row-major (rank = coordinates in row-major order). Every rank of the
    default group must call it with the same arguments."""
    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(names) or min(shape, default=1) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {names}")
    world, me = dist.world_size(), dist.rank()
    size = math.prod(shape)
    if size > world:
        raise ValueError(f"a {shape} mesh needs {size} ranks; the group "
                         f"has {world}")
    coords = [_coords(r, shape) for r in range(size)]
    traffic = dist.Traffic()
    axes = {}
    for k, name in enumerate(names):
        group, line = None, (me,)
        for ranks, g in _axis_groups(shape, k, coords, world).items():
            if me in ranks:
                group, line = g, ranks
        if me < size:
            axes[name] = dist.Axis(name, shape[k], coords[me][k], group,
                                   line, dist.transport(), traffic)
    return WorkerMesh(names, shape, axes if me < size else None,
                      dist.transport(), traffic)


#: the process groups of each mesh layout and group of ranks: creating one
#: is a collective call and torch never frees it, so a layout's groups are
#: built once per process (every rank builds the same layouts in the same
#: order, so every rank hits or misses together)
_GROUPS: dict = {}


def _axis_groups(shape: tuple, k: int, coords: list, world: int) -> dict:
    """The ranks that differ from each other only along axis ``k`` -> their
    process group (None along an axis of size 1)."""
    key = (shape, k, tdist.group.WORLD)
    if key not in _GROUPS:
        lines: dict = {}
        for r, c in enumerate(coords):
            lines.setdefault(c[:k] + c[k + 1:], []).append(r)
        _GROUPS[key] = {
            tuple(ranks): (None if shape[k] == 1
                           else tdist.group.WORLD if len(ranks) == world
                           else tdist.new_group(ranks))
            for ranks in lines.values()}
    return _GROUPS[key]


def _coords(r: int, shape: tuple) -> tuple:
    """Rank ``r``'s row-major coordinates in a mesh of ``shape``."""
    out = []
    for s in reversed(shape):
        r, c = divmod(r, s)
        out.append(c)
    return tuple(reversed(out))


def production_mesh_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(sizes, axis names) of the production mesh: 16 x 16 = 256 chips a
    pod, ("data", "model"); the multi-pod mesh adds a leading 2-pod axis
    (512 chips)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> WorkerMesh:
    """The production mesh over the first 256 (or 512) ranks of the group;
    raises when the group has fewer, as the reference does without enough
    devices. The dry run lays state out on
    ``make_abstract_mesh(*production_mesh_shape(...))`` instead."""
    return make_mesh(*production_mesh_shape(multi_pod))


def make_worker_mesh(workers: Optional[int] = None,
                     axis_name: str = "workers") -> WorkerMesh:
    """1-D mesh over the first ``workers`` ranks (default: every rank of
    the group) for the MR-HAP clustering runtime."""
    return make_mesh((workers or dist.world_size(),), (axis_name,))


def factor_2d(ranks: int) -> tuple[int, int]:
    """(rows, cols) of the 2-D mesh the engine builds over ``ranks``: the
    largest divisor not above the square root, as rows."""
    rows = max(math.isqrt(ranks), 1)
    while ranks % rows:
        rows -= 1
    return rows, ranks // rows
