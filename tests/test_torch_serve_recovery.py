"""Worker-failure recovery in the port's cluster service, on the CPU:
each test of ``tests/test_serve_recovery.py`` on
``repro_torch.serve.cluster``.

The contract: every future the service hands out resolves — a result, a
deadline error, or ``WorkerFailedError`` — whatever dies underneath it.
Failures are injected deterministically via the port's
``repro_torch.runtime.faultinject`` (sites ``serve.launch`` and
``serve.compile``). Every threaded wait has a timeout.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import gaussian_blobs  # noqa: E402
from repro_torch.runtime import faultinject  # noqa: E402
from repro_torch.runtime.faultinject import FaultInjector, Rule  # noqa: E402
from repro_torch.serve.cluster import (  # noqa: E402
    ClusterService, DeadlineExceededError, WorkerFailedError,
)
from repro_torch.serve.cluster import service as service_mod  # noqa: E402
from repro_torch.solver import SolveConfig  # noqa: E402

CFG = SolveConfig(stop="converged", max_iterations=60, damping=0.6,
                  preference="median", device="cpu")


def _blobs(n, seed=0):
    x, _ = gaussian_blobs(n=n, k=4, seed=seed, spread=0.3, box=12.0)
    return x


def _service(workers=2, **kw):
    kw.setdefault("worker_cooldown_s", 0.0)
    kw.setdefault("retry_backoff_ms", 1.0)
    svc = ClusterService(config=CFG, buckets=[(64, 2, 2)],
                         auto_bucket=False, workers=workers, **kw)
    svc.warmup()
    return svc


def test_failed_launch_retries_on_survivor():
    """One worker's launch dies: its riders retry on the survivor and
    every future still resolves with a result."""
    svc = _service(workers=2)
    inj = FaultInjector().add(Rule("serve.launch", nth=0))
    with faultinject.active(inj):
        futs = [svc.submit(_blobs(40, seed=s)) for s in range(6)]
        svc.drain()
    for f in futs:
        assert f.result(timeout=5).path == "full"
    s = svc.stats
    assert s.worker_deaths == 1 and s.retried_batches >= 1
    assert s.resurrections >= 1            # cooldown 0: drain revives it


def test_queued_requests_redistribute_off_dead_worker():
    """Work already queued on the dead shard moves to the survivor
    instead of stranding."""
    svc = _service(workers=2, worker_cooldown_s=60.0)
    inj = FaultInjector().add(Rule("serve.launch", match={"worker": 0}))
    with faultinject.active(inj):
        futs = [svc.submit(_blobs(40, seed=s)) for s in range(8)]
        svc.drain()
    for f in futs:
        assert f.result(timeout=5).path == "full"
    assert svc.stats.worker_deaths == 1
    assert svc.stats.requeued_requests >= 1
    healthy = [w["healthy"] for w in svc.snapshot()["workers"]]
    assert healthy == [False, True]        # cooldown keeps 0 down


def test_retries_exhaust_to_worker_failed_error():
    """With every launch and every resurrection compile failing, the
    future fails with WorkerFailedError — it must never hang."""
    svc = _service(workers=1)
    inj = (FaultInjector()
           .add(Rule("serve.launch", nth=0, times=50))
           .add(Rule("serve.compile", nth=0, times=50)))
    with faultinject.active(inj):
        fut = svc.submit(_blobs(40))
        svc.drain()
        with pytest.raises(WorkerFailedError):
            fut.result(timeout=5)


def test_unhealthy_worker_resurrects_with_fresh_cache():
    """After the fault clears, the next dispatch revives the worker with
    a *new*, fully warmed CompileCache — whatever poisoned the old one is
    discarded wholesale."""
    svc = _service(workers=1)
    old_cache = svc.workers[0].cache
    inj = (FaultInjector()
           .add(Rule("serve.launch", nth=0, times=50))
           .add(Rule("serve.compile", nth=0, times=50)))
    with faultinject.active(inj):
        fut = svc.submit(_blobs(40))
        svc.drain()
        with pytest.raises(WorkerFailedError):
            fut.result(timeout=5)
    fut2 = svc.submit(_blobs(40))
    svc.drain()
    assert fut2.result(timeout=5).path == "full"
    assert svc.workers[0].healthy
    assert svc.workers[0].cache is not old_cache
    assert svc.stats.resurrections == 1
    # the fresh cache is warmed before taking traffic: zero request-path
    # compiles after resurrection
    assert svc.workers[0].cache.snapshot()["hits"] >= 1


def test_retry_is_bounded_by_deadline():
    """A retry whose backoff would breach the rider's SLO fails with
    DeadlineExceededError — deadline semantics beat retry semantics."""
    svc = _service(workers=2, retry_backoff_ms=200.0)
    inj = FaultInjector().add(Rule("serve.launch", nth=0))
    with faultinject.active(inj):
        fut = svc.submit(_blobs(40), deadline_ms=80.0)
        svc.drain()
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=5)
    assert svc.stats.deadline_drops == 1


def test_drift_resolve_failure_releases_and_retries():
    """Satellite: a drift-triggered background re-solve that dies on a
    failing worker releases ``resolve_pending`` (the stream keeps serving
    stale assignments), and the next drift crossing schedules a fresh
    re-solve that succeeds after the worker resurrects."""
    svc = ClusterService(config=CFG, buckets=[(128, 2, 2)],
                         auto_bucket=False, workers=1,
                         worker_cooldown_s=0.0, retry_backoff_ms=1.0,
                         drift_threshold=0.2, drift_halflife=8)
    svc.warmup()
    rng = np.random.default_rng(2)
    svc.solve_sync(rng.normal(size=(60, 2)).astype(np.float32), stream="s")
    far = (rng.normal(size=(40, 2)) + 70.0).astype(np.float32)
    r = svc.submit(far, stream="s").result(timeout=10)
    assert r.assign.resolve_triggered
    # the queued internal re-solve dies; resurrection is blocked too, so
    # the failure is terminal for this attempt
    inj = (FaultInjector()
           .add(Rule("serve.launch", nth=0, times=50))
           .add(Rule("serve.compile", nth=0, times=50)))
    with faultinject.active(inj):
        svc.drain()
    assert svc.stream_info("s")["resolve_pending"] is False
    # stale service continues: the stream still answers on the old
    # exemplar set via the fast path
    stale = svc.submit(far, stream="s").result(timeout=10)
    assert stale.path == "assign"
    gen0 = svc.stream_info("s")["generation"]
    # fault cleared: the next drift crossing re-solves successfully
    # (dispatch resurrects the worker with a fresh warmed cache first)
    svc.submit(far, stream="s").result(timeout=10)
    svc.drain()
    assert svc.stream_info("s")["generation"] == gen0 + 1
    assert svc.stats.worker_deaths == 1 and svc.stats.resurrections == 1


def test_pump_death_fails_pending_futures(monkeypatch):
    """Watchdog: a scheduler thread dying outside the per-batch guard
    fails every pending future instead of stranding callers, and later
    submits fail fast while the pumps are down."""
    svc = ClusterService(config=CFG, buckets=[(64, 2, 2)],
                         auto_bucket=False, workers=1, max_wait_ms=1.0)
    svc.warmup()

    def bomb(shard):
        raise MemoryError("pump bomb")
    monkeypatch.setattr(service_mod, "pop_batch", bomb)
    svc.start()
    try:
        fut = svc.submit(_blobs(40))
        with pytest.raises(WorkerFailedError):
            fut.result(timeout=10)
        fut2 = svc.submit(_blobs(40))       # pumps dead: fail fast
        with pytest.raises(WorkerFailedError):
            fut2.result(timeout=5)
    finally:
        monkeypatch.undo()
        svc.stop(timeout=30)
    assert svc.stats.worker_deaths >= 1


def test_threaded_recovery_under_load():
    """start()-mode: kill one of two workers mid-traffic; every future
    resolves and the service keeps serving on the survivor + the
    resurrected worker."""
    svc = _service(workers=2, worker_cooldown_s=0.05, max_wait_ms=1.0)
    inj = FaultInjector().add(Rule("serve.launch", nth=1,
                                   match={"worker": 1}))
    svc.start()
    try:
        with faultinject.active(inj):
            futs = [svc.submit(_blobs(40, seed=s)) for s in range(10)]
            for f in futs:
                assert f.result(timeout=60).path == "full"
    finally:
        svc.stop(timeout=30)
    assert svc.stats.worker_deaths <= 1    # at most the injected one


def test_chaos_full_tier_every_future_resolves():
    """The chaos tier's shape at a CPU size: four workers, three kills of
    worker 1 at ``serve.launch`` under Poisson load with a 2,000 ms
    deadline. Every future resolves with a result; each kill is one
    worker death, and the service resurrects and retries around it."""
    from repro_torch.serve.cluster.loadgen import run_load, synthetic_requests

    svc = ClusterService(config=CFG.replace(levels=2),
                         buckets=[(64, 2, 4)], auto_bucket=False,
                         workers=4, max_wait_ms=1.0, max_retries=3,
                         worker_cooldown_s=0.2, retry_backoff_ms=2.0)
    svc.warmup()
    inj = FaultInjector(seed=7).add(
        Rule("serve.launch", nth=0, times=3, match={"worker": 1}))
    with faultinject.active(inj):
        res = run_load(svc, synthetic_requests(24, [(64, 2)], seed=2),
                       rps=40.0, seed=2, deadline_ms=2000.0, timeout=60.0)
    assert res.n_requests == 24 and res.n_errors == 0
    assert len(inj.events) >= 1
    assert svc.stats.worker_deaths >= 1
    assert svc.stats.retried_batches >= 1
    assert svc.stats.worker_deaths <= len(inj.events)
