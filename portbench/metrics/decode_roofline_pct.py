"""decode_roofline_pct: the decode steps' roofline bound over their device
time, in %. The bound of each traced call's steps is the larger of their
counted bytes (``counts/<counts>.decode_bytes``) at the card's HBM rate
and their counted FLOPs (``decode_flops``) at its bfloat16 peak; the time
is the device time of the kernels launched inside the decode spans."""
import importlib

from portbench import roofline


def read(r):
    s = r.shapes
    if r.calls == 0 or not r.has("decode") or "counts" not in s:
        return None
    ns = r.device_in("decode")
    if not ns:
        return None
    counts = importlib.import_module(f"portbench.counts.{s['counts']}")
    peaks = roofline.PEAKS
    bound = sum(max(
        counts.decode_bytes(s["config"], b, p, s["new"])
        / peaks["hbm_bytes_per_s"],
        counts.decode_flops(s["config"], b, p, s["new"])
        / peaks["bf16_flops_per_s"]) for b, p in s["calls"])
    return 100.0 * bound / (ns / 1e9)
