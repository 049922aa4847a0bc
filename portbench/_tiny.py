"""Cells of ``BENCHMARK.json`` cut to a size the CPU tests can run: the
same configuration, mix and limits, fewer points, a pool of 2, and on the
top-k layout the route stated (on the CPU ``auto`` picks a dense backend
at these sizes) and k = 16."""
from __future__ import annotations

from portbench import spec

SIZES = {
    "mandrill-dense": ({"h": 20, "w": 20}, {}),
    "blobs-200k-topk": ({"n": 1000}, {"backend": "dense_topk", "k": 16}),
}


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.find_cell(spec.load_benchmark(), name)
    data, solve = SIZES[cell.config["name"]]
    return cell._replace(data={**cell.data, **data},
                         solve={**cell.solve, **solve},
                         mix={**cell.mix, "pool": 2})
