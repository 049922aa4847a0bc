"""The program's own spans and counters, as a traced window saw them.

The port opens ``repro_torch.<name>`` spans in ``solve()`` while a
profiler records, and keeps counters that are always on
(``repro_torch.obs``). ``of(reading)`` turns the window's trace into a
``Program`` for the readers in ``portbench/metrics/`` that use them:

* each span's host time;
* the device time and the count of the device operations launched inside
  each innermost program span (a kernel is matched to the host call that
  launched it by the profiler's correlation ids, as ``tracing.read``
  does);
* the synchronising runtime calls (``SYNCS``) made inside the program's
  ``solve`` spans, by the innermost program span and the op that made
  each one.

``tracing.Reading`` carries only the benchmark's own spans, so this
module takes the window's profile from the frame that holds it while the
readers run (``run.run_cell``'s), found by its type up the stack, and
parses it once a reading. Device-side ranges named as spans are shadows
of spans, not work, and are skipped, as ``tracing.read`` skips them.
A run of a program that has no such spans or counters (a commit before
them) finds nothing here, and its metrics are left out.

Each parse also prints the window's idle gaps labelled by the innermost
span of either family, the program's or the benchmark's, and the
synchronising calls by op, to standard error.
"""
from __future__ import annotations

import bisect
import importlib
import sys
import time
from collections import Counter, defaultdict
from typing import NamedTuple, Optional

import numpy as np
from torch.autograd import DeviceType
from torch.profiler import profile

from portbench import tracing

SPAN = tracing.PROGRAM_PREFIX
OBS = "repro_torch.obs"
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})
#: the four phase spans of a sweep
PHASES = ("sweep.r", "sweep.a", "sweep.levels", "sweep.assign")


class Program(NamedTuple):
    host_ns: dict          # span -> host time inside it
    device_ns: dict        # innermost program span -> device time launched
    device_ops: dict       # innermost program span -> device ops launched
    on_device: bool        # the window holds device activity
    syncs: int             # synchronising calls inside the solve spans
    syncs_by_op: dict      # "<innermost span>: <op>" -> count
    idle_gaps: list        # [[label, seconds]], top 10


_last: list = []           # [(reading, Program or None)]


def of(reading) -> Optional[Program]:
    """The program's spans in the window ``reading`` was read from."""
    if _last and _last[0][0] is reading:
        return _last[0][1]
    prof, t0 = _profile(), time.perf_counter()
    got = None if prof is None else parse(
        prof.profiler.kineto_results.events())
    _last[:] = [(reading, got)]
    if got is not None:
        print(f"portbench: the program's spans read in "
              f"{time.perf_counter() - t0:.1f} s\n"
              "portbench: idle gaps by the innermost span of either "
              f"family: {got.idle_gaps}\n"
              f"portbench: synchronising calls by op: {got.syncs_by_op}",
              file=sys.stderr)
    return got


def phase_ms(reading, phase: str) -> Optional[float]:
    """Device time launched inside the program's ``phase`` spans, over the
    sweeps run, in ms."""
    p = of(reading)
    if p is None or reading.sweeps == 0 or not p.device_ns.get(phase):
        return None
    return p.device_ns[phase] / 1e6 / reading.sweeps


def counters() -> Optional[dict]:
    """The program's counters since the process started, or None where
    the program keeps none."""
    try:
        obs = importlib.import_module(OBS)
    except ImportError:
        return None
    return obs.counters()


def _profile():
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, profile):
                return value
        frame = frame.f_back
    return None


def _innermost(spans: list, times: list) -> list:
    """For each time, the innermost span around it (None outside every
    span); spans are (start, end, label) and nest."""
    spans = [sp for sp in spans if sp[1] > sp[0]]     # empty ones hold none
    marks = [(s, 1, i) for i, (s, _, _) in enumerate(spans)]
    marks += [(e, 0, i) for i, (_, e, _) in enumerate(spans)]
    marks += [(t, 2, j) for j, t in enumerate(times)]
    marks.sort()
    out, open_ = [None] * len(times), []
    for _, kind, i in marks:
        if kind == 1:
            open_.append(i)
        elif kind == 0:
            del open_[len(open_) - 1 - open_[::-1].index(i)]
        elif open_:
            out[i] = spans[open_[-1]]
    return out


def parse(events) -> Optional[Program]:
    spans, bench = [], []                # (start, end, label)
    win = None
    launch_at, ops, op_spans, device, syncs = {}, {}, [], [], []
    for e in events:
        name = e.name()
        if name.startswith("aten::"):          # most events: skip the tests
            ops[e.correlation_id()] = (e.start_ns(), name)
            op_spans.append((e.start_ns(), e.end_ns(), name))
        elif e.device_type() != DeviceType.CPU:
            if not name.startswith(tracing.SPAN_PREFIXES):
                device.append((e.start_ns(), e.end_ns(), name,
                               e.correlation_id(),
                               e.linked_correlation_id()))
        elif name.startswith(SPAN):
            spans.append((e.start_ns(), e.end_ns(), name[len(SPAN):]))
        elif name.startswith(tracing.PREFIX):
            if name == tracing.PREFIX + "window":
                win = (e.start_ns(), e.end_ns())
            else:
                bench.append((e.start_ns(), e.end_ns(),
                              name[len(tracing.PREFIX):]))
        elif name.startswith(("cuda", "cu")) and not name.startswith(
                "cudnn"):
            launch_at[e.correlation_id()] = e.start_ns()
            if name in SYNCS:
                syncs.append(e.start_ns())
        else:
            ops[e.correlation_id()] = (e.start_ns(), name)
            op_spans.append((e.start_ns(), e.end_ns(), name))
    if not spans or win is None:
        return None

    host_ns = defaultdict(int)
    for s, e, label in spans:
        host_ns[label] += e - s

    def launched(d):
        t = launch_at.get(d[3])
        if t is None and d[4] in ops:
            t = ops[d[4]][0]
        return t

    device = [d for d in device if min(d[1], win[1]) > max(d[0], win[0])]
    timed = [(d, launched(d)) for d in device]
    timed = [(d, t) for d, t in timed if t is not None]
    where = _innermost(spans, [t for _, t in timed])
    device_ns, device_ops = defaultdict(int), Counter()
    for (d, _), sp in zip(timed, where):
        if sp is not None:
            device_ns[sp[2]] += d[1] - d[0]
            device_ops[sp[2]] += 1

    solves = sorted((s, e) for s, e, label in spans if label == "solve")
    starts = [s for s, _ in solves]

    def in_solve(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and solves[i][0] <= t < solves[i][1]

    sync_at = sorted(t for t in syncs if in_solve(t))
    syncs_by_op = Counter(_sync_ops(sync_at, spans, op_spans))
    return Program(
        host_ns=dict(host_ns), device_ns=dict(device_ns),
        device_ops=dict(device_ops), on_device=bool(device),
        syncs=len(sync_at), syncs_by_op=dict(syncs_by_op.most_common()),
        idle_gaps=_idle_gaps(device, win, spans, bench, launched, ops))


def _sync_ops(sync_at: list, spans: list, op_spans: list) -> list:
    """For each synchronising call (times sorted), ``<span>: <op>``: the
    innermost program span around it and the outermost op the program
    called inside that span (``aten::bincount``, not the ``aten::copy_``
    that it makes)."""
    inner = _innermost(spans, sync_at)
    best = [None] * len(sync_at)            # (start, name) of the op
    at = np.asarray(sync_at, dtype=np.int64)
    ivs = np.asarray([(s, e) for s, e, _ in op_spans],
                     dtype=np.int64).reshape(-1, 2)
    first = np.searchsorted(at, ivs[:, 0])
    holds = np.flatnonzero(
        (first < len(at))
        & (at[np.minimum(first, len(at) - 1)] < ivs[:, 1])) if len(at) \
        else []
    for j in holds:
        s, e, name = op_spans[j]
        i = int(first[j])
        while i < len(sync_at) and sync_at[i] < e:
            if s >= inner[i][0] and (best[i] is None or s < best[i][0]):
                best[i] = (s, name)
            i += 1
    return [f"{sp[2]}: {op[1] if op else '(no op)'}"
            for sp, op in zip(inner, best)]


def _idle_gaps(device, win, spans, bench, launched, ops) -> list:
    """``tracing``'s idle gaps, labelled by the innermost span of either
    family at the gap's middle (``repro_torch.<name>`` for the program's),
    and the host call that launched the device work that ended the gap."""
    busy = tracing._merge([(max(d[0], win[0]), min(d[1], win[1]))
                           for d in device])
    edges = [(win[0], win[0])] + [tuple(m) for m in busy] + \
        [(win[1], win[1])]
    gaps = [(a, b) for (_, a), (b, _) in zip(edges, edges[1:])
            if b - a >= tracing.GAP_MIN_NS]
    both = bench + [(s, e, SPAN + label) for s, e, label in spans]
    where = [sp and sp[2] for sp in
             _innermost(both, [(a + b) // 2 for a, b in gaps])]
    firsts = sorted((d[0], i) for i, d in enumerate(device))
    first_starts = [s for s, _ in firsts]
    by_label = defaultdict(int)
    for (a, b), label in zip(gaps, where):
        i = bisect.bisect_left(first_starts, b)
        what = "end of window"
        if i < len(firsts):
            d = device[firsts[i][1]]
            op = ops.get(d[4])
            what = op[1] if op is not None and launched(d) is not None \
                else d[2]
        by_label[f"{label or 'window'}: {what}"] += b - a
    top = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    return [[label, ns / 1e9] for label, ns in top]
