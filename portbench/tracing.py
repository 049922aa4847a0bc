"""Spans around the program's layers, and what a ``torch.profiler`` trace
of the window says about them.

The program has no spans of its own, so the benchmark opens them: for
each layer the configuration's ``spans`` names the module attributes that
``solve()`` reaches the layer through, and ``Spans`` replaces each with a
wrapper that runs it inside ``record_function("portbench.<layer>")``. No
span synchronises. The harness opens ``portbench.solve`` around each call
and ``portbench.window`` around the window.

``read`` turns the trace into a ``Reading``: each layer's host time, the
device time of the kernels launched inside its spans (a kernel is matched
to the host call that launched it by the profiler's correlation ids), the
device's busy time over the window, the device operations that took most
time, and the longest idle gaps by what the host was doing.
"""
from __future__ import annotations

import bisect
import importlib
import sys
from collections import defaultdict
from typing import NamedTuple

from torch.autograd import DeviceType
from torch.profiler import record_function

PREFIX = "portbench."
PROGRAM_PREFIX = "repro_torch."      # the program's spans (``program.py``)
#: a span of either family that is a user-scope range has a shadow on the
#: device's timeline, which is not work
SPAN_PREFIXES = (PREFIX, PROGRAM_PREFIX)
GAP_MIN_NS = 20_000       # idle gaps shorter than this are not labelled


class Spans:
    """Context manager: wraps the configuration's entry points in spans
    and puts the originals back on exit."""

    def __init__(self, spans: dict):
        self.spans = spans
        self.missing: set = set()      # layers whose entry point is absent
        self._undo: list = []

    def __enter__(self):
        for layer, targets in self.spans.items():
            for target in targets:
                modname, attr = target.split(":")
                mod = importlib.import_module(modname)
                if not hasattr(mod, attr):
                    self.missing.add(layer)
                    print(f"portbench: span {layer!r}: {target} does not "
                          "exist; its metrics are left out", file=sys.stderr)
                    continue
                orig = getattr(mod, attr)
                setattr(mod, attr, _wrapped(orig, PREFIX + layer))
                self._undo.append((mod, attr, orig))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()
        return False


def _wrapped(fn, name: str):
    def span(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    span.__wrapped__ = fn
    return span


class Reading(NamedTuple):
    calls: int
    sweeps: int                 # sweeps run over the traced calls
    shapes: dict                # n, d, k, levels, layout
    window_ns: int
    busy_ns: int                # union of device activity in the window
    host_ns: dict               # layer -> host time inside its spans
    solve_self_ns: int          # solve spans less their child spans
    device_by_layers: dict      # frozenset of layers -> device ns
    missing: set                # layers whose entry points are absent
    top_ops: list               # [[name, seconds]] device ops, top 10
    idle_gaps: list             # [[label, seconds]] idle by host, top 10

    def has(self, layer: str) -> bool:
        return layer not in self.missing and layer in self.host_ns

    def device_in(self, layer: str, without: tuple = ()) -> int:
        return sum(ns for key, ns in self.device_by_layers.items()
                   if layer in key and not key.intersection(without))


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _containing(intervals: list, starts: list, t: int) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and intervals[i][0] <= t < intervals[i][1]


def read(prof, calls: int, sweeps: int, shapes: dict,
         missing: set) -> Reading:
    events = prof.profiler.kineto_results.events()
    spans = defaultdict(list)            # layer -> [(start, end)]
    launch_at = {}                       # runtime correlation -> start
    ops = {}                             # op correlation -> (start, name)
    device = []                          # (start, end, name, corr, link)
    for e in events:
        name = e.name()
        if name.startswith("aten::"):    # most events: host ops, tested first
            ops[e.correlation_id()] = (e.start_ns(), name)
        elif e.device_type() != DeviceType.CPU:
            if name.startswith(SPAN_PREFIXES):   # the spans' shadows
                continue
            device.append((e.start_ns(), e.end_ns(), name,
                           e.correlation_id(), e.linked_correlation_id()))
        elif name.startswith(PREFIX):
            spans[name[len(PREFIX):]].append((e.start_ns(), e.end_ns()))
        elif name.startswith(("cuda", "cu")) and not name.startswith(
                "cudnn"):
            launch_at[e.correlation_id()] = e.start_ns()
        else:
            ops[e.correlation_id()] = (e.start_ns(), name)

    win = spans.pop("window", [(0, 0)])[0]
    layers = {k: sorted(v) for k, v in spans.items()}
    starts = {k: [s for s, _ in v] for k, v in layers.items()}

    def launched(d):
        t = launch_at.get(d[3])
        if t is None and d[4] in ops:
            t = ops[d[4]][0]
        return t

    busy = []
    device_by_layers = defaultdict(int)
    totals = defaultdict(int)
    for d in device:
        s, e = max(d[0], win[0]), min(d[1], win[1])
        if e <= s:
            continue
        busy.append((s, e))
        totals[d[2]] += d[1] - d[0]
        t = launched(d)
        if t is not None:
            key = frozenset(k for k in layers
                            if _containing(layers[k], starts[k], t))
            device_by_layers[key] += d[1] - d[0]
    merged = _merge(busy)

    host_ns = {k: sum(e - s for s, e in v) for k, v in layers.items()}
    solve_self = 0
    children = [iv for k, v in layers.items() if k != "solve" for iv in v]
    for s, e in layers.get("solve", []):
        inside = [(max(a, s), min(b, e)) for a, b in children
                  if a < e and b > s]
        solve_self += (e - s) - sum(b - a for a, b in _merge(inside))

    top_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    gaps = _idle_gaps(merged, win, layers, device, launched, ops)
    return Reading(
        calls=calls, sweeps=sweeps, shapes=shapes,
        window_ns=win[1] - win[0], busy_ns=sum(e - s for s, e in merged),
        host_ns=host_ns, solve_self_ns=solve_self,
        device_by_layers=dict(device_by_layers), missing=missing,
        top_ops=[[n, ns / 1e9] for n, ns in top_ops], idle_gaps=gaps)


def _idle_gaps(merged, win, layers, device, launched, ops) -> list:
    """Idle time of the window, summed by label: the innermost span the
    host was in at the gap's middle, and the host call that launched the
    device work that ended the gap."""
    first_after = sorted((d[0], d) for d in device)
    firsts = [s for s, _ in first_after]
    flat = sorted((s, e, k) for k, v in layers.items() for s, e in v)
    flat_starts = [s for s, _, _ in flat]
    by_label = defaultdict(int)
    edges = [(win[0], win[0])] + [tuple(m) for m in merged] + \
        [(win[1], win[1])]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b - a < GAP_MIN_NS:
            continue
        mid = (a + b) // 2
        where = "window"
        # the span that started last among those around mid: later
        # starts nest deeper
        j = bisect.bisect_right(flat_starts, mid) - 1
        while j >= 0:
            if flat[j][1] > mid:
                where = flat[j][2]
                break
            j -= 1
        i = bisect.bisect_left(firsts, b)
        what = "end of window"
        if i < len(first_after):
            d = first_after[i][1]
            op = ops.get(d[4])
            what = op[1] if op is not None and launched(d) is not None \
                else d[2]
        by_label[f"{where}: {what}"] += b - a
    top = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    return [[label, ns / 1e9] for label, ns in top]


def profile(device_type: str, host_ops: bool = True):
    """A ``torch.profiler`` over the host and, on a card, the device.
    With ``host_ops`` false the host records only the spans (user-scope
    ``record_function``s) and the runtime calls that launch the kernels,
    not every ``aten`` op: on a path that issues thousands of small ops
    a step, recording each of them slows the host that paces the device."""
    from torch.profiler import ProfilerActivity, profile as _profile
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = _profile(activities=acts)
    return prof if host_ops else _SpansOnly(prof)


class _SpansOnly:
    """Starts ``prof`` with its host recording limited to user-scope
    ``record_function``s, through the ``scopes`` argument of the
    profiler's enable call (``torch.profiler`` does not expose it)."""

    def __init__(self, prof):
        self.prof = prof

    def __enter__(self):
        import torch.autograd.profiler as ap
        from torch._C._profiler import RecordScope

        enable = ap._enable_profiler

        def spans_only(config, activities, *args, **kwargs):
            return enable(config, activities, {RecordScope.USER_SCOPE})

        ap._enable_profiler = spans_only
        try:
            self.prof.__enter__()
        finally:
            ap._enable_profiler = enable
        return self.prof

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)
