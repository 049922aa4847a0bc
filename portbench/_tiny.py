"""Cells of ``BENCHMARK.json`` cut to a size the CPU tests can run: the
same configuration, mix and limits, smaller inputs and a pool of 2. On
the top-k layout the route is stated (on the CPU ``auto`` picks a dense
backend at these sizes) and k = 16. A language model's cut is its
reference module's ``SMOKE`` (``portbench/reference/<module>.py``), so a
new configuration brings its own: ``lm_dense``'s keeps the family and
takes the port's CPU-smoke widths (``ArchConfig.reduced``) and two
layers, two inputs (2 prompts of 16 tokens, 3 of 8), and 4 new tokens."""
from __future__ import annotations

import importlib

from portbench import spec

SIZES = {
    "mandrill-dense": {"data": {"h": 20, "w": 20}},
    "blobs-200k-topk": {"data": {"n": 1000},
                        "solve": {"backend": "dense_topk", "k": 16}},
}


def tiny_cell(name: str, bench=None, root=spec.ROOT) -> spec.Cell:
    bench = spec.load_benchmark(root) if bench is None else bench
    cell = spec.find_cell(bench, name, root)
    cut = SIZES.get(cell.config["name"])
    if cut is None:
        cut = importlib.import_module(
            f"portbench.reference.{cell.config['reference']['module']}"
        ).SMOKE
    return cut_cell(cell, cut)


def cut_cell(cell: spec.Cell, cut: dict) -> spec.Cell:
    return cell._replace(config={**cell.config, **cut.get("config", {})},
                         data={**cell.data, **cut.get("data", {})},
                         solve={**cell.solve, **cut.get("solve", {})},
                         mix={**cell.mix, "pool": 2, **cut.get("mix", {})})
