"""``repro_torch.obs``: the solve path's spans and counters.

The spans cost nothing but a check while no profiler records, nest under
one as the solve path states them (``solve`` around ``prepare``,
``build``, ``preference``, ``sweeps`` and ``finalize``; the four phases of
a sweep inside ``sweeps``), and the counters lose no increment under
threads. Runs on the CPU at tiny sizes.
"""
from __future__ import annotations

import sys
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    launch_counts, reset_launch_counts,
)
from repro_torch.solver import solve  # noqa: E402
from repro_torch.solver.topk import (  # noqa: E402
    sample_generator, sampled_preferences,
)

TOP = ("prepare", "build", "sweeps", "finalize")
PHASES = ("sweep.r", "sweep.a", "sweep.levels", "sweep.assign")


def _points(n=120, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 2)).astype(np.float32)


def _spans(prof):
    """[(start, end, name)] of the program's spans, by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name()[len(obs.PREFIX):])
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(obs.PREFIX))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was opened without a profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd._profiler_enabled()
    assert obs.span("solve", call=3) is obs.span("sweep.r")
    with obs.span("x"):
        pass
    res = solve(_points(), device="cpu", backend="dense_fused",
                max_iterations=3)
    assert res.n_sweeps == 3


@pytest.mark.parametrize("kw", [
    {"backend": "dense_fused", "preference": "random"},
    {"backend": "dense_parallel"},
    {"backend": "dense_topk", "k": 16},
    {"backend": "dense_fused", "stop": "converged", "patience": 2},
], ids=["fused-random", "parallel", "topk", "converged"])
def test_spans_nest_as_the_solve_path_states(kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = solve(_points(), device="cpu", max_iterations=6, **kw)
    spans = _spans(prof)
    by = {}
    for sp in spans:
        by.setdefault(sp[2], []).append(sp)
    (root,) = by["solve"]
    tops = [by[name][0] for name in TOP]
    assert all(len(by[name]) == 1 for name in TOP + ("preference",))
    assert all(_inside(sp, root) for sp in tops)
    assert [sp[2] for sp in sorted(tops)] == list(TOP)   # in this order
    (pref,) = by["preference"]
    if kw["backend"] == "dense_topk":
        assert pref[0] >= by["build"][0][1]       # after the build
        assert _inside(pref, root) and pref[1] <= by["sweeps"][0][0]
    else:
        assert _inside(pref, by["build"][0])       # inside the build
    sweeps = by["sweeps"][0]
    n = res.n_sweeps
    assert [len(by[p]) for p in PHASES] == [n, n, 2 * n - 1, n]
    assert all(_inside(sp, sweeps) for p in PHASES for sp in by[p])
    phases = sorted(sp for p in PHASES for sp in by[p])
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))


def test_the_solve_span_carries_its_call_number():
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        solve(_points(), device="cpu", backend="dense_fused",
              max_iterations=2)
    (e,) = [e for e in prof.profiler.kineto_results.events()
            if e.name() == obs.PREFIX + "solve"]
    assert e.kwinputs() == {"call": obs.counters()["solves"]}


def test_counters_stay_exact_under_threads():
    obs.reset_counters("t.")
    n_threads, per = 8, 4000
    start = threading.Barrier(n_threads)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer(i):
            start.wait(timeout=30)
            for _ in range(per):
                obs.count(f"t.{i % 3}")
                obs.count("t.all", 2)

        threads = [threading.Thread(target=hammer, args=(i,), daemon=True)
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    got = {k: v for k, v in obs.counters().items() if k.startswith("t.")}
    assert got == {"t.0": 3 * per, "t.1": 3 * per, "t.2": 2 * per,
                   "t.all": 2 * n_threads * per}
    obs.reset_counters("t.")
    assert not any(k.startswith("t.") for k in obs.counters())


def test_counters_copy_and_reset_by_prefix():
    obs.reset_counters("u.")
    assert obs.count("u.a") == 1 and obs.count("u.a", 4) == 5
    obs.count("u.b")
    snap = obs.counters()
    snap["u.a"] = 0                               # a copy
    assert obs.counters()["u.a"] == 5
    obs.reset_counters("u.a")
    assert "u.a" not in obs.counters() and obs.counters()["u.b"] == 1
    obs.reset_counters("u.")


def test_launch_counts_are_a_view_of_the_counters():
    reset_launch_counts()
    obs.count("launches.similarity", 2)
    obs.count("other.kept")
    assert launch_counts()["similarity"] == 2
    assert sum(launch_counts().values()) == 2
    reset_launch_counts()
    assert sum(launch_counts().values()) == 0
    assert obs.counters()["other.kept"] >= 1
    obs.reset_counters("other.")


@pytest.mark.parametrize("kw,want", [
    ({"backend": "dense_fused", "preference": "random"},
     {"input": 1, "random_preference": 1, "sweeps": 1, "finalize": 1}),
    ({"backend": "dense_topk", "k": 16},
     {"input": 1, "sweeps": 1, "finalize": 1}),
    ({"backend": "dense_fused", "stop": "converged", "patience": 2},
     {"input": 1, "sweeps": None, "finalize": 1}),
], ids=["fused-random", "topk", "converged"])
def test_a_solve_counts_its_host_copies(kw, want):
    obs.reset_counters("host_copies.")
    res = solve(_points(), device="cpu", max_iterations=6, **kw)
    got = {k[len("host_copies."):]: v for k, v in obs.counters().items()
           if k.startswith("host_copies.")}
    if want["sweeps"] is None:                # one read a sweep
        want = {**want, "sweeps": res.n_sweeps}
    assert got == want
    # a tensor already on the device is not copied
    obs.reset_counters("host_copies.")
    solve(torch.from_numpy(_points()), device="cpu", max_iterations=2,
          backend="dense_fused")
    assert "host_copies.input" not in obs.counters()


def test_the_preference_subsample_counts_its_copy():
    x = torch.from_numpy(_points(2100, seed=1))
    obs.reset_counters("host_copies.")
    sampled_preferences(x, "median", "neg_sqeuclidean", sample_generator(0))
    got = {k: v for k, v in obs.counters().items()
           if k.startswith("host_copies.")}
    assert got == {"host_copies.preference_sample": 1}
