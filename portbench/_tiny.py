"""Cells of ``BENCHMARK.json`` cut to a size the CPU tests can run: the
same configuration, mix and limits, smaller inputs and a pool of 2. On
the top-k layout the route is stated (on the CPU ``auto`` picks a dense
backend at these sizes) and k = 16; a language model keeps its family and
takes the port's CPU-smoke widths (``ArchConfig.reduced``) and two
layers, two inputs (2 prompts of 16 tokens, 3 of 8), and 4 new tokens."""
from __future__ import annotations

from portbench import spec

LM_SMOKE = {"hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 16, "intermediate_size": 128, "vocab_size": 256}

SIZES = {
    "mandrill-dense": {"data": {"h": 20, "w": 20}},
    "blobs-200k-topk": {"data": {"n": 1000},
                        "solve": {"backend": "dense_topk", "k": 16}},
    "qwen2.5-32b-pp4": {
        "config": LM_SMOKE,
        "data": {"vocab": 256,
                 "per_input": [{"batch": 2, "prompt_len": 16},
                               {"batch": 3, "prompt_len": 8}]},
        "mix": {"generate": {"steps": 4}}},
}


def tiny_cell(name: str, bench=None, root=spec.ROOT) -> spec.Cell:
    bench = spec.load_benchmark(root) if bench is None else bench
    cell = spec.find_cell(bench, name, root)
    cut = SIZES[cell.config["name"]]
    return cut_cell(cell, cut)


def cut_cell(cell: spec.Cell, cut: dict) -> spec.Cell:
    return cell._replace(config={**cell.config, **cut.get("config", {})},
                         data={**cell.data, **cut.get("data", {})},
                         solve={**cell.solve, **cut.get("solve", {})},
                         mix={**cell.mix, "pool": 2, **cut.get("mix", {})})
