"""Roofline terms of a step (port of ``repro/launch/hlo_analysis.py``).

The reference parses collectives out of XLA's optimized HLO and converts
them to per-chip wire bytes with ring equivalents. The port has no HLO:
its collectives are the explicit calls of ``sharding.dist``, which count
the bytes each rank sends as they run (``launch/hlo_cost.py`` reads them
per kind). What is left here is the roofline.
"""
from __future__ import annotations

#: NVIDIA's data-sheet values for one H100 SXM (dense rates, no sparsity,
#: at its 700 W power limit); not measurements
H100_SXM = {
    "flops_bf16": 989e12,      # FLOP/s, bf16 tensor cores, dense
    "hbm_bw": 3.35e12,         # B/s, HBM3
    "link_bw": 450e9,          # B/s each way, NVLink 4 (900 GB/s in all)
}


def roofline_terms(flops: float, hbm_bytes: float, wire_bytes: float,
                   chips: int, hw: dict = H100_SXM) -> dict:
    """Seconds per step for each roofline term, per chip.

    ``flops``, ``hbm_bytes`` and ``wire_bytes`` are one device's totals
    over the step (every rank runs the same program)."""
    t_compute = flops / hw["flops_bf16"]
    t_memory = hbm_bytes / hw["hbm_bw"]
    t_coll = wire_bytes / hw["link_bw"]
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    return {"compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_coll, "dominant": dominant}
