"""mfu_device_pct: the traced calls' counted FLOPs
(``counts/<counts>.call_flops``: the least any exact implementation
needs) over the seconds in which the device was busy in the window, at
the card's bfloat16 peak (``peaks.json``), in %: the whole calls' share
of the chip's peak while it works. The denominator is device time, which
the profiler does not stretch, and not the window's wall time, which it
does on a host-paced path; the device's idle share beside it is the
result line's ``busy_s`` against ``window_s``. A window with no device
activity reads nothing."""
import importlib

from portbench import roofline


def read(r):
    s = r.shapes
    if r.calls == 0 or r.busy_ns <= 0 or "counts" not in s:
        return None
    counts = importlib.import_module(f"portbench.counts.{s['counts']}")
    flops = sum(counts.call_flops(s["config"], b, p, s["new"])
                for b, p in s["calls"])
    return 100.0 * flops / (r.busy_ns / 1e9
                            * roofline.PEAKS["bf16_flops_per_s"])
