"""build_roofline_pct: the top-k build's roofline bound (``roofline.
topk_build_bound_s`` from N, d and k) over its device time a call
(``build_ms``), in %."""
from portbench import roofline
from portbench.metrics import build_ms


def read(r):
    ms = build_ms.read(r)
    if ms is None or r.shapes["layout"] != "topk":
        return None
    s = r.shapes
    return 100.0 * roofline.topk_build_bound_s(s["n"], s["d"], s["k"]) \
        / (ms / 1e3)
