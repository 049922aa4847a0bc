"""Elastic scaling: reshard a logical state tree onto a different mesh
(port of ``repro/runtime/elastic.py``).

Checkpoints are stored mesh-agnostically (full logical arrays: a mesh run
gathers its blocks with ``gather_state`` before the writer saves), so
scaling a job down after losing a pod, or up after capacity returns, is
restoring the tree and taking this rank's block of every leaf on the new
mesh. Spec trees are the same co-declared trees of ``P`` the train step
uses, filtered for whatever axes the new mesh has.
"""
from __future__ import annotations

from typing import Any

from repro_torch.models.layers.common import P, tree_map
from repro_torch.sharding.partitioning import (
    Sharding, _divisible_spec, filter_spec,
)
from repro_torch.solver.engine import resolve_device


def _sharding(leaf, spec: P, mesh) -> Sharding:
    """The leaf's layout on ``mesh``. Where the axis-filtered spec does not
    divide the leaf the reference's ``device_put`` refuses it; so does
    this."""
    spec = filter_spec(spec, mesh.axis_names)
    if _divisible_spec(spec, tuple(leaf.shape), mesh) != spec:
        raise ValueError(f"a leaf of shape {tuple(leaf.shape)} cannot be "
                         f"laid out as {spec} on a {mesh.shape} mesh")
    return Sharding(mesh, spec)


def reshard_state(state: Any, spec_tree: Any, mesh, device=None) -> Any:
    """This rank's block of every leaf of ``state`` (tensors or numpy
    arrays, full logical shapes) per its logical spec in ``spec_tree``, on
    ``device`` (None: the card; raises without one)."""
    device = resolve_device(device)
    return tree_map(lambda s, x: _sharding(x, s, mesh).block(x).to(device),
                    spec_tree, state, is_leaf=lambda s: isinstance(s, P))


def gather_state(blocks: Any, spec_tree: Any, mesh) -> Any:
    """The inverse of ``reshard_state``: every rank of ``mesh`` gets the
    full logical arrays (all-gathers over each leaf's axes). A collective
    call: every rank of the mesh makes it, as the sharded checkpoints'
    gathers do; the writer then saves what a one-device run would."""
    return tree_map(
        lambda s, b: Sharding(mesh, filter_spec(s, mesh.axis_names)
                              ).gather(b),
        spec_tree, blocks, is_leaf=lambda s: isinstance(s, P))


def validate_mesh_change(
    old_shape: dict[str, int], new_shape: dict[str, int],
    global_batch: int,
) -> list[str]:
    """Static checks before an elastic transition; returns warnings."""
    warnings = []
    old_data = old_shape.get("data", 1) * old_shape.get("pod", 1)
    new_data = new_shape.get("data", 1) * new_shape.get("pod", 1)
    if global_batch % new_data:
        warnings.append(
            f"global_batch={global_batch} not divisible by new data "
            f"extent {new_data}; adjust batch or pad")
    if new_shape.get("model", 1) != old_shape.get("model", 1):
        warnings.append(
            "model-parallel extent changed: parameter layout moves between "
            "devices (full reshard, ~2x checkpoint-size traffic)")
    if new_data < old_data:
        warnings.append("data extent shrank: per-device batch grows; "
                        "check activation memory headroom")
    return warnings
