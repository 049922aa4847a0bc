"""Data partitioning and process groups (port of ``repro/sharding``): the
kd median-cut partitioner, ``row_block``, and in ``sharding.dist`` the
collectives over ``torch.distributed``. The reference's jax-version shims
and spec helpers have no counterpart yet."""
from repro_torch.sharding.partitioning import kd_cells, kd_median_cut, row_block

__all__ = ["kd_cells", "kd_median_cut", "row_block"]
