"""Mesh specs, data partitioning and process groups (port of
``repro/sharding``): the spec helpers and the mesh context, the kd
median-cut partitioner, ``row_block``, and in ``sharding.dist`` the
collectives over ``torch.distributed``. Of the reference's jax-version
shims only the mesh context has a counterpart (``set_mesh``,
``get_abstract_mesh``, ``make_abstract_mesh``); ``make_mesh`` is
``repro_torch.launch.mesh.make_mesh``."""
from repro_torch.sharding.partitioning import (
    P, AbstractMesh, Sharding, filter_spec, get_abstract_mesh, kd_cells,
    kd_median_cut, make_abstract_mesh, maybe_shard, row_block, set_mesh,
    shape_safe_shardings, tree_shardings,
)

__all__ = ["filter_spec", "maybe_shard", "shape_safe_shardings",
           "tree_shardings", "get_abstract_mesh", "make_abstract_mesh",
           "set_mesh", "P", "AbstractMesh", "Sharding", "kd_cells",
           "kd_median_cut", "row_block"]
