"""Data partitioning (port of the data side of ``repro/sharding``): the kd
median-cut partitioner. The reference's mesh helpers have no counterpart."""
from repro_torch.sharding.partitioning import kd_cells, kd_median_cut

__all__ = ["kd_cells", "kd_median_cut"]
