"""Quickstart for the PyTorch/CUDA port: cluster 2-D points with
Hierarchical Affinity Propagation through ``repro_torch.solver.solve``.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port's counterpart of ``examples/quickstart.py``: the same data and
the same call. ``solve`` runs on the card unless told ``device="cpu"``
(without a card it raises rather than falling back), builds similarities
and preferences, routes to a backend (on the card the dense path's
hand-written kernels), runs damped message-passing sweeps with a
per-sweep convergence trace, and returns the hierarchy.
"""
import argparse

from repro_torch.core import link_hierarchy, purity
from repro_torch.data import aggregation_like
from repro_torch.solver import solve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    # 788 2-D points in 7 clusters (the paper's Aggregation shape set)
    x, labels = aggregation_like()

    # 3-level hierarchy, 40 damped sweeps; stop="converged" exits early
    # once the per-sweep count of assignment changes flatlines
    result = solve(x, levels=3, damping=0.7, max_iterations=40,
                   preference="median", device=args.device)
    print(f"backend={result.backend} sweeps={result.n_sweeps} "
          f"changes/sweep (last 5): {result.trace[-5:].tolist()}")

    hier = link_hierarchy(result.exemplars)
    for level in range(3):
        print(f"level {level}: {hier.n_clusters[level]:3d} clusters, "
              f"purity {purity(hier.labels[level], labels):.3f}")
    print("parents of level-0 clusters:", hier.parents[0][:10], "...")


if __name__ == "__main__":
    main()
