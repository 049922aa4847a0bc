"""The paper's comparison baselines (port of ``repro/baselines``): K-means,
MapReduce K-means over the ranks of a group, Canopy, and HK-Means."""
from repro_torch.baselines.canopy import canopy_centers
from repro_torch.baselines.hkmeans import hierarchical_kmeans
from repro_torch.baselines.kmeans import kmeans, kmeans_distributed

__all__ = ["canopy_centers", "hierarchical_kmeans", "kmeans",
           "kmeans_distributed"]
