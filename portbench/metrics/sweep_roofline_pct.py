"""sweep_roofline_pct: a sweep's roofline bound (``roofline.
sweep_bound_s`` of the layout, N, L and k) over its device time
(``sweep_ms``), in %."""
from portbench import roofline
from portbench.metrics import sweep_ms


def read(r):
    ms = sweep_ms.read(r)
    if ms is None or r.shapes["layout"] not in roofline.LAYOUTS:
        return None
    s = r.shapes
    return 100.0 * roofline.sweep_bound_s(s["layout"], s["n"], s["levels"],
                                          s["k"] or 0) / (ms / 1e3)
