"""The port's multi-worker dispatch layer on the CPU: each test of
``tests/test_serve_dispatch.py`` on ``repro_torch.serve.cluster`` (SLO
deadlines, admission control, work stealing, batch-ladder right-sizing,
traffic-fitted buckets, the atomicity of the stats snapshot), and the
kernels' launch counts under threads.

Pure scheduling tests use ``WorkerShard``/``close_at``/``steal_batch``
directly; the end-to-end ones share one small warmed service. Every
threaded wait has a timeout.
"""
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import gaussian_blobs  # noqa: E402
from repro_torch.serve.cluster import (  # noqa: E402
    Bucket, ClusterService, DeadlineExceededError, ServiceOverloadedError,
    batch_ladder, ladder_fit,
)
from repro_torch.serve.cluster.dispatch import (  # noqa: E402
    ClusterRequest, WorkerShard, close_at, pop_batch, steal_batch,
)
from repro_torch.serve.cluster.traffic import (  # noqa: E402
    fit_buckets, mine_trace,
)
from repro_torch.solver import SolveConfig  # noqa: E402

CFG = SolveConfig(stop="converged", max_iterations=60, damping=0.6,
                  levels=2, preference="median", device="cpu")


def _req(n=8, **kw):
    kw.setdefault("submitted", time.perf_counter())
    return ClusterRequest(np.zeros((n, 2), np.float32), n, Future(),
                          None, **kw)


def _blobs(n, seed):
    x, _ = gaussian_blobs(n=n, k=4, seed=seed, spread=0.3, box=14.0)
    return x


@pytest.fixture(scope="module")
def service2w():
    svc = ClusterService(config=CFG, buckets=[(64, 2, 4)],
                         auto_bucket=False, workers=2)
    svc.warmup()
    return svc


# ------------------------------------------------------------- batch ladder
def test_batch_ladder_powers_of_two():
    assert batch_ladder(8) == (1, 2, 4, 8)
    assert batch_ladder(6) == (1, 2, 4, 6)
    assert batch_ladder(1) == (1,)


def test_ladder_fit_picks_smallest_cover():
    assert ladder_fit(8, 1) == 1
    assert ladder_fit(8, 3) == 4
    assert ladder_fit(8, 8) == 8
    assert ladder_fit(6, 5) == 6


def test_run_batch_right_sizes_launch(service2w):
    """A lone rider in a batch-4 bucket must run the batch-1 variant —
    visible as one executable lookup hit on that exact shape."""
    svc = service2w
    x = _blobs(40, seed=1)
    fut = svc.submit(x)
    svc.drain()
    assert fut.result().labels.shape == (40,)
    # the batch-1 variant exists and was used (hit count grew on lookup)
    w = svc.workers
    assert any(wk.cache.lookup(Bucket(64, 2, 1), svc.config) is not None
               for wk in w)


# ------------------------------------------------------------- close timing
def test_close_at_empty_shard_is_none():
    w = WorkerShard(0)
    with w.lock:
        assert close_at(w, time.perf_counter(), 0.05) is None


def test_close_at_full_batch_closes_now():
    w = WorkerShard(0)
    key = (64, 2, 2)
    for _ in range(2):
        w.try_admit(_req(), key)
    now = time.perf_counter()
    with w.lock:
        assert close_at(w, now, 10.0) == now


def test_close_at_deadline_preempts_gather_window():
    """A rider with a tight deadline collapses the gather window: the
    batch must close at deadline - est(bucket), not submitted + max_wait
    — the deadline-driven early close."""
    w = WorkerShard(0)
    key = (64, 2, 4)
    now = time.perf_counter()
    w.try_admit(_req(submitted=now), key)                 # slack rider
    w.try_admit(_req(submitted=now, deadline=now + 0.02), key)  # tight
    with w.lock:
        t = close_at(w, now, max_wait_s=10.0)
    # est defaults to 50 ms > the 20 ms budget: close immediately-ish
    assert t is not None and t <= now + 0.02
    assert t < now + 1.0                                  # not the window


def test_close_at_uses_learned_estimate():
    w = WorkerShard(0)
    key = (64, 2, 4)
    w.note_launch(key, 0.010)                             # 10 ms EWMA
    now = time.perf_counter()
    w.try_admit(_req(submitted=now, deadline=now + 0.5), key)
    with w.lock:
        t = close_at(w, now, max_wait_s=10.0)
    assert t == pytest.approx(now + 0.5 - w.est_s(key))


def test_overflow_closes_immediately():
    w = WorkerShard(0)
    w.try_admit(_req(n=999), None)
    now = time.perf_counter()
    with w.lock:
        assert close_at(w, now, 10.0) == now


# ---------------------------------------------------------- deadlines (e2e)
def test_deadline_expired_at_submit_rejects_immediately(service2w):
    fut = service2w.submit(_blobs(20, seed=2), deadline_ms=0)
    with pytest.raises(DeadlineExceededError):
        fut.result(timeout=1)
    assert service2w.snapshot()["deadline_rejects"] >= 1


def test_deadline_expired_in_queue_drops_at_launch(service2w):
    """A request whose deadline passes while queued is dropped when its
    batch launches — error on the future, counted, no compute burned."""
    svc = service2w
    fut = svc.submit(_blobs(30, seed=3), deadline_ms=1.0)
    time.sleep(0.05)                       # let it expire in the queue
    before = svc.snapshot()["deadline_drops"]
    svc.drain()
    with pytest.raises(DeadlineExceededError):
        fut.result(timeout=1)
    assert svc.snapshot()["deadline_drops"] == before + 1


def test_deadline_mid_gather_closes_batch_early():
    """Threaded: with a long gather cap, a deadline-carrying rider must
    be served well before the cap (the scheduler closed early for it)."""
    svc = ClusterService(config=CFG, buckets=[(64, 2, 4)],
                         auto_bucket=False, workers=1,
                         max_wait_ms=5000.0)       # cap alone would stall
    svc.warmup()
    # teach the estimator this bucket is fast, so the early-close margin
    # is small and the timing assertion is about the deadline, not est
    svc.workers[0].note_launch((64, 2, 4), 0.02)
    svc.start()
    try:
        t0 = time.perf_counter()
        fut = svc.submit(_blobs(40, seed=4), deadline_ms=300.0)
        res = fut.result(timeout=10)
        elapsed = time.perf_counter() - t0
    finally:
        svc.stop(timeout=30)
    assert res.path == "full"
    assert elapsed < 2.0                   # nowhere near the 5 s cap


# ------------------------------------------------------- admission control
def test_admission_rejection_releases_future():
    """Shed requests must fail fast with ServiceOverloadedError — the
    future resolves (no caller left hanging) and the shed is counted."""
    svc = ClusterService(config=CFG, buckets=[(64, 2, 2)],
                         auto_bucket=False, workers=2, max_queue=2)
    svc.warmup()
    x = _blobs(20, seed=5)
    kept = [svc.submit(x) for _ in range(4)]       # fills 2 x 2 slots
    shed = svc.submit(x)
    with pytest.raises(ServiceOverloadedError):
        shed.result(timeout=1)                     # resolved, not hanging
    assert svc.snapshot()["sheds"] == 1
    svc.drain()
    assert all(f.exception(timeout=5) is None for f in kept)


def test_internal_resolve_bypasses_admission():
    """Drift re-solves are force-admitted: a full queue must not wedge
    the stream refresh machinery."""
    svc = ClusterService(config=CFG, buckets=[(64, 2, 2)],
                         auto_bucket=False, workers=1, max_queue=1)
    svc.warmup()
    x = _blobs(20, seed=6)
    svc.submit(x)                                  # occupies the 1 slot
    req = ClusterRequest(x, len(x), Future(), None,
                         time.perf_counter(), internal=True)
    svc._dispatch(req, (64, 2, 2))
    assert svc.workers[0].depth() == 2             # admitted past bound
    assert svc.snapshot()["sheds"] == 0


def test_dispatch_prefers_least_loaded(service2w):
    svc = service2w
    svc.drain()                                    # start from empty
    futs = [svc.submit(_blobs(20, seed=7)) for _ in range(4)]
    depths = [w.depth() for w in svc.workers]
    assert sorted(depths) == [2, 2]                # spread, not piled
    svc.drain()
    for f in futs:
        assert f.exception(timeout=5) is None


# ----------------------------------------------------------- work stealing
def test_steal_batch_takes_from_deepest_peer():
    a, b, c = WorkerShard(0), WorkerShard(1), WorkerShard(2)
    b.try_admit(_req(), (64, 2, 4))
    for _ in range(3):
        c.try_admit(_req(), (64, 2, 4))
    grabbed = steal_batch(a, [a, b, c])
    assert grabbed is not None
    bucket, reqs = grabbed
    assert len(reqs) == 3                          # came from c (deepest)
    assert c.depth() == 0 and b.depth() == 1


def test_steal_never_starves_nonempty_queue():
    """Even when the depth-ordered first victims turn out empty (stale
    depth or races), a non-empty peer anywhere must still be found."""
    a, b, c = WorkerShard(0), WorkerShard(1), WorkerShard(2)
    b.queued = 50            # lies: deepest by depth(), actually empty
    c.try_admit(_req(), (64, 2, 4))
    grabbed = steal_batch(a, [a, b, c])
    assert grabbed is not None and len(grabbed[1]) == 1
    assert c.depth() == 0


def test_drain_worker_steals_cross_shard(service2w):
    """All work on worker 0's shard; draining worker 1 serves it anyway
    and counts the theft."""
    svc = service2w
    svc.drain()
    x = _blobs(30, seed=8)
    reqs = [ClusterRequest(x, len(x), Future(), None,
                           time.perf_counter()) for _ in range(3)]
    for r in reqs:
        assert svc.workers[0].try_admit(r, (64, 2, 4))
    before = svc.snapshot()["stolen_batches"]
    n = svc.drain_worker(1)
    assert n >= 1
    assert svc.snapshot()["stolen_batches"] == before + 1
    for r in reqs:
        assert r.future.exception(timeout=5) is None


# ----------------------------------------------------- traffic-fitted shapes
def test_mine_trace_accepts_all_forms(tmp_path):
    assert mine_trace([(60, 2), (60, 2), (120, 2, 5)]) == {
        (60, 2): 2, (120, 2): 5}
    assert mine_trace({"64x2": 3, (128, 2): 1}) == {(64, 2): 3, (128, 2): 1}
    rec = {"rows": [{"shape_counts": {"60x2": 4}},
                    {"shape_counts": {"60x2": 1, "500x3": 2}}]}
    assert mine_trace(rec) == {(60, 2): 5, (500, 3): 2}
    p = tmp_path / "BENCH_serve.json"
    p.write_text('{"rows": [{"shape_counts": {"100x2": 7}}]}')
    assert mine_trace(str(p)) == {(100, 2): 7}


def test_fit_buckets_covers_every_dim_within_budget():
    shapes = {(60, 2): 40, (120, 2): 10, (500, 3): 2}
    fitted = fit_buckets(shapes, max_buckets=4, max_batch=8)
    assert len(fitted) <= 4
    # every observed shape routes into some fitted bucket of its dim
    for (n, d), _ in shapes.items():
        assert any(n <= bn and d == bd for bn, bd, _b in fitted)
    # hot small shapes get their own edge + the biggest batch
    by_edge = {(bn, bd): bb for bn, bd, bb in fitted}
    assert (64, 2) in by_edge
    assert by_edge[(64, 2)] == max(by_edge.values())


def test_fit_buckets_single_budget_collapses_to_max_edge():
    fitted = fit_buckets({(60, 2): 5, (120, 2): 5}, max_buckets=1)
    assert [(n, d) for n, d, _ in fitted] == [(128, 2)]


def test_fit_buckets_rejects_empty_and_overconstrained():
    with pytest.raises(ValueError, match="no usable"):
        fit_buckets({})
    with pytest.raises(ValueError, match="feature dims"):
        fit_buckets({(64, 2): 1, (64, 3): 1}, max_buckets=1)


def test_from_trace_end_to_end():
    svc = ClusterService.from_trace(
        {"rows": [{"shape_counts": {"50x2": 20}}]}, config=CFG,
        max_batch=2)
    assert [b.key for b in svc.router.buckets] == [(64, 2, 2)]
    assert svc.router.auto is False        # fitted tables are fixed
    svc.warmup()
    res = svc.solve_sync(_blobs(50, seed=9))
    assert res.path == "full" and res.bucket == (64, 2, 2)


# ----------------------------------------------------- multi-worker e2e
def test_multiworker_zero_postwarmup_compiles_per_worker(service2w):
    """Each worker's own cache must stay compile-free after warmup under
    mixed multi-worker traffic — the per-worker acceptance gate."""
    svc = service2w
    svc.drain()
    warm_misses = {w["worker"]: w["cache"]["misses"]
                   for w in svc.snapshot()["workers"]}
    futs = [svc.submit(_blobs(20 + 3 * i, seed=20 + i))
            for i in range(12)]
    svc.drain()
    for f in futs:
        assert f.exception(timeout=10) is None
    for w in svc.snapshot()["workers"]:
        assert w["cache"]["misses"] == warm_misses[w["worker"]]


def test_stats_snapshot_is_atomic_under_load(service2w):
    """Counters mutate from scheduler threads; snapshot() must hand back
    one consistent copy (dict, not live references) without tearing."""
    svc = service2w
    svc.drain()
    stop = threading.Event()
    errs = []

    def hammer():
        # a pause between reads: the port's solves are many small eager
        # ops, each of which retakes the GIL, and a reader that never
        # sleeps holds it for the interpreter's whole switch interval
        while not stop.wait(5e-4):
            s = svc.snapshot()
            try:
                # a torn read would show fewer solves than batches
                assert s["full_solves"] >= s["micro_batches"] >= 0
                assert set(s["cache"]) == {"hits", "misses",
                                           "compile_seconds"}
            except AssertionError as e:    # pragma: no cover
                errs.append(e)
                return

    th = threading.Thread(target=hammer, daemon=True)
    th.start()
    svc.start()
    try:
        futs = [svc.submit(_blobs(25, seed=40 + i)) for i in range(10)]
        for f in futs:
            assert f.exception(timeout=30) is None
    finally:
        svc.stop(timeout=30)
        stop.set()
        th.join(timeout=5)
    assert not errs
    # the returned dict is a copy: mutating it must not corrupt service
    snap = svc.snapshot()
    snap["requests"] = -1
    assert svc.snapshot()["requests"] != -1


# ------------------------------------------------- launch counts and threads
def test_launch_counter_loses_no_increment_under_threads():
    """Eight threads count 5,000 launches each as every wrapper does
    (``obs.count("launches.<kernel>")``): the total is exact, and a reset
    under load leaves the counts consistent."""
    from repro_torch import obs
    from repro_torch.kernels import (
        KERNELS, launch_counts, reset_launch_counts,
    )

    reset_launch_counts()
    start = threading.Barrier(8)

    def hammer(i):
        start.wait(timeout=30)
        name = KERNELS[i % len(KERNELS)]
        for _ in range(5000):
            obs.count("launches." + name)

    threads = [threading.Thread(target=hammer, args=(i,), daemon=True)
               for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    counts = launch_counts()
    reset_launch_counts()
    want = {name: 5000 * sum(1 for i in range(8)
                             if KERNELS[i % len(KERNELS)] == name)
            for name in KERNELS}
    assert counts == want
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_plain_paths_count_nothing_from_worker_threads():
    """On CPU tensors the wrappers take their plain versions and count no
    launch, from any thread; the serve path's batched solves launch no
    kernel either (``dense_fused`` maps to the parallel order)."""
    from repro_torch.kernels import (
        launch_counts, reset_launch_counts, similarity, topk_build,
    )

    reset_launch_counts()
    x = torch.from_numpy(_blobs(64, seed=1))

    def work():
        similarity.neg_sqeuclidean(x, x)
        topk_build.topk_similarity_fused(x, 8)

    threads = [threading.Thread(target=work, daemon=True) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    svc = ClusterService(config=CFG.replace(backend="dense_fused"),
                         buckets=[(64, 2, 2)], auto_bucket=False, workers=2)
    svc.warmup()
    svc.start()
    try:
        futs = [svc.submit(_blobs(40, seed=s)) for s in range(4)]
        for f in futs:
            assert f.result(timeout=60).path == "full"
    finally:
        svc.stop(timeout=30)
    assert sum(launch_counts().values()) == 0
