"""CPU tests of the readers of the program's own spans and counters
(``portbench/program.py`` and the eight metrics that use it): what a traced
CPU run reports, that the seven older metrics read the same with or
without the program's spans in the trace, what the readers make of a
trace with device activity, and a run of a program without counters."""
from __future__ import annotations

import importlib
import io
import time
from contextlib import redirect_stdout
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import profile

from portbench import _tiny, loadgen, program, run, spec, tracing
from repro_torch.solver import solve

OLD = ["idle_pct", "engine_self_ms", "preference_ms", "build_ms",
       "build_roofline_pct", "sweep_ms", "sweep_roofline_pct"]
NEW = ["finalize_ms", "sweep_r_ms", "sweep_a_ms", "sweep_levels_ms",
       "sweep_assign_ms", "kernels_per_sweep", "host_syncs_per_solve",
       "host_copies_per_solve"]
ON_DEVICE = NEW[1:7]
SHAPES = {"n": 200_000, "d": 2, "k": 64, "levels": 3, "layout": "topk"}


def _read(name, reading):
    return importlib.import_module(f"portbench.metrics.{name}").read(reading)


class _Profile(profile):
    """A finished profile holding the given events."""

    def __init__(self, events):
        self.profiler = SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events))


class _Ev:
    def __init__(self, name, start, end, corr=0, linked=0, device=False):
        self._v = (name, start * 1000, end * 1000, corr, linked, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def linked_correlation_id(self):
        return self._v[4]

    def device_type(self):
        return DeviceType.CUDA if self._v[5] else DeviceType.CPU


def _events(shadow=False):
    """One solve of one sweep as a card's trace shows it (times in us):
    kernels launched inside three phase spans and a copy read in the
    fourth, two waits inside ``solve`` and one outside it, an idle gap
    while ``finalize`` runs; ``shadow`` adds a device-side range named as
    a program span."""
    ev = [
        _Ev("portbench.window", 0, 1000),
        _Ev("portbench.solve", 10, 900),
        _Ev("repro_torch.solve", 12, 890, 1),
        _Ev("repro_torch.prepare", 14, 40, 2),
        _Ev("portbench.sweep", 100, 600),
        _Ev("repro_torch.sweeps", 110, 590, 3),
        _Ev("repro_torch.sweep.r", 120, 200, 4),
        _Ev("cudaLaunchKernel", 130, 135, 100, 4),
        _Ev("responsibility_kernel", 300, 400, 100, 4, device=True),
        _Ev("repro_torch.sweep.a", 210, 300, 5),
        _Ev("aten::add", 220, 260, 6),
        _Ev("cudaLaunchKernel", 230, 235, 101, 6),
        _Ev("add_kernel", 400, 450, 101, 6, device=True),
        _Ev("repro_torch.sweep.levels", 310, 350, 7),
        _Ev("aten::amax", 315, 345, 8),
        _Ev("cudaLaunchKernel", 320, 325, 102, 8),
        _Ev("reduce_kernel", 450, 500, 102, 8, device=True),
        _Ev("repro_torch.sweep.assign", 360, 580, 9),
        _Ev("aten::_local_scalar_dense", 370, 570, 10),
        _Ev("cudaMemcpyAsync", 380, 385, 103, 10),
        _Ev("Memcpy DtoH", 500, 510, 103, 10, device=True),
        _Ev("cudaStreamSynchronize", 390, 560, 104, 10),
        _Ev("repro_torch.finalize", 700, 880, 11),
        _Ev("aten::to", 710, 800, 12),
        _Ev("aten::copy_", 715, 795, 13),
        _Ev("cudaStreamSynchronize", 720, 790, 105, 12),
        _Ev("cudaLaunchKernel", 895, 896, 106, 0),
        _Ev("fill_kernel", 905, 950, 106, 0, device=True),
        _Ev("cudaDeviceSynchronize", 897, 960, 107, 0),
        _Ev("portbench.sweep", 300, 510, device=True),
    ]
    if shadow:
        ev.append(_Ev("repro_torch.sweeps", 300, 510, device=True))
    return ev


def _reading(events):
    return tracing.read(_Profile(events), calls=1, sweeps=1, shapes=SHAPES,
                        missing=set())


@pytest.mark.parametrize("name", ["blobs-200k-topk.d2",
                                  "mandrill-dense.median"])
def test_a_cpu_trace_run_reports_the_program_metrics(name):
    out = run.run_cell(_tiny.tiny_cell(name), 2 ** 31 + 5, 0.0, True, "cpu",
                       time.perf_counter())
    got = out["metrics"]
    assert {"finalize_ms", "host_copies_per_solve"} <= set(got)
    assert got["finalize_ms"]["value"] > 0
    assert got["host_copies_per_solve"]["value"] >= 1
    assert not set(ON_DEVICE) & set(got)        # no device on the CPU
    cell = spec.find_cell(spec.load_benchmark(), name)
    assert set(NEW) <= {m["name"] for m in cell.per_layer}


def test_the_older_metrics_read_the_same_without_the_program_spans():
    """One CPU window recorded as the harness records it, read whole and
    with every ``repro_torch.*`` event taken out; then the same on a trace
    with device activity."""
    cell = _tiny.tiny_cell("blobs-200k-topk.d2")
    x = torch.from_numpy(loadgen.make_pool(cell.data, 1, 7)[0])
    overrides = {**cell.solve, "device": "cpu"}
    with tracing.Spans(cell.config["spans"]), tracing.profile("cpu") as prof:
        with tracing.record_function(tracing.PREFIX + "window"):
            for _ in range(2):
                with tracing.record_function(tracing.PREFIX + "solve"):
                    res = solve(x, **overrides)
    recorded = list(prof.profiler.kineto_results.events())
    assert any(e.name() == "repro_torch.finalize" for e in recorded)
    for events in (recorded, _events()):
        bare = [e for e in events if not e.name().startswith("repro_torch.")]
        whole = tracing.read(_Profile(events), calls=2,
                             sweeps=2 * res.n_sweeps, shapes=SHAPES,
                             missing=set())
        less = tracing.read(_Profile(bare), calls=2,
                            sweeps=2 * res.n_sweeps, shapes=SHAPES,
                            missing=set())
        assert [_read(m, whole) for m in OLD] == [_read(m, less) for m in OLD]
        assert whole.top_ops == less.top_ops
        assert whole._replace(idle_gaps=[]) == less._replace(idle_gaps=[])


def test_the_readers_on_a_trace_with_device_activity():
    prof = _Profile(_events(shadow=True))      # found up the stack
    reading = _reading(_events())
    p = program.of(reading)
    assert prof is not None and p is program.of(reading)     # parsed once
    assert p.host_ns["finalize"] == 180_000 and p.on_device
    assert p.device_ns == {"sweep.r": 100_000, "sweep.a": 50_000,
                           "sweep.levels": 50_000, "sweep.assign": 10_000}
    assert p.syncs == 2 and p.syncs_by_op == {
        "sweep.assign: aten::_local_scalar_dense": 1,
        "finalize: aten::to": 1}
    assert p.idle_gaps[0] == ["repro_torch.finalize: fill_kernel",
                              pytest.approx(395e-6)]
    got = {m: _read(m, reading) for m in NEW[:7]}
    assert got == pytest.approx({
        "finalize_ms": 0.18, "sweep_r_ms": 0.1, "sweep_a_ms": 0.05,
        "sweep_levels_ms": 0.05, "sweep_assign_ms": 0.01,
        "kernels_per_sweep": 4.0, "host_syncs_per_solve": 2.0})


def test_a_trace_without_the_program_spans_reads_nothing():
    events = [e for e in _events() if not e.name().startswith("repro_")]
    prof = _Profile(events)
    reading = _reading(events)
    assert prof is not None and program.of(reading) is None
    assert all(_read(m, reading) is None for m in NEW[:7])


def test_a_run_without_the_program_counters_leaves_out_that_metric(
        monkeypatch):
    monkeypatch.setattr(program, "OBS", "repro_torch._no_such_module")
    cell = _tiny.tiny_cell("mandrill-dense.median")
    out = run.run_cell(cell, 2 ** 31 + 9, 0.0, True, "cpu",
                       time.perf_counter())
    dev = {"platform": "gpu", "kind": "test", "count": 1,
           "memory_peak_bytes": 1}
    with redirect_stdout(io.StringIO()):
        line = run.result_line(out, dev, True)
    assert line["correct"] is True
    assert "host_copies_per_solve" not in line["metrics"]
    assert {"engine_self_ms", "finalize_ms"} <= set(line["metrics"])
