"""Roofline counts of the benchmark's kernels, from the cell's shapes
alone.

Each counts the least work that any exact implementation needs (not what
today's kernels do), at the fastest rate the card offers for that work
(``peaks.json``), so that no implementation reads above 100 % and no
kernel fused or replaced later makes a count stale.

- A dense sweep reads r and a and writes r and a on every level, and
  reads s once, since every level holds the same s: (4 L + 1) N^2
  float32.
- A top-k sweep does the same on the stored entries, (4 L + 1) N (k + 1)
  float32, and reads the (N, k + 1) column map once.
- A top-k build reads the points and writes the lists, N d 4 + N k 8
  bytes; computes N^2 dot products of d products and d sums, at the
  tensor cores' float32-accurate rate (3xTF32); and makes one comparison
  a pair, at the float32 rate. Its bound is the largest of the three.
"""
from __future__ import annotations

import json
from pathlib import Path

F32 = 4
PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


LAYOUTS = ("dense", "topk")


def sweep_bytes(layout: str, n: int, levels: int, k: int = 0) -> float:
    if layout == "dense":
        return (4.0 * levels + 1) * n * n * F32
    if layout == "topk":
        return (4.0 * levels + 2) * n * (k + 1) * F32
    raise ValueError(f"no sweep count for layout {layout!r}")


def sweep_bound_s(layout: str, n: int, levels: int, k: int = 0,
                  peaks: dict = PEAKS) -> float:
    return sweep_bytes(layout, n, levels, k) / peaks["hbm_bytes_per_s"]


def topk_build_terms_s(n: int, d: int, k: int,
                       peaks: dict = PEAKS) -> dict:
    return {
        "bytes": (n * d * F32 + n * k * 8) / peaks["hbm_bytes_per_s"],
        "products": n * n * 2.0 * d / peaks["fp32_products_tensor_core_per_s"],
        "comparisons": n * float(n) / peaks["fp32_flops_per_s"],
    }


def topk_build_bound_s(n: int, d: int, k: int, peaks: dict = PEAKS) -> float:
    return max(topk_build_terms_s(n, d, k, peaks).values())
