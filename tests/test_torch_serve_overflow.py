"""The port's clustering service on the CPU, continued from
``test_torch_serve.py``: requests past the buckets (overflow to
``dense_topk`` and to ``coarsen``, the overflow preference) and the
streams' drift-triggered background re-solves. Shared fixtures in
``tests/_torch_serve.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_serve import CFG, _blobs, service  # noqa: E402,F401
from repro_torch.serve.cluster import ClusterService  # noqa: E402
from repro_torch.solver import SolveConfig, solve  # noqa: E402


def test_overflow_routes_to_dense_topk(service):
    """A request past every bucket runs as one direct dense_topk solve
    (capped k): served with the same response contract, no new compiled
    executable, counted in overflow stats."""
    x, _ = _blobs(500, seed=11)
    compiled_before = service.snapshot()["compiled"]
    res = service.solve_sync(x)
    assert res.path == "full" and res.bucket is None
    assert res.solve.backend == "dense_topk"
    ref = solve(x, backend="dense_topk", k=min(service.overflow_k, 499),
                stop="converged", max_iterations=80, damping=0.6,
                levels=2, preference="median", device="cpu")
    np.testing.assert_array_equal(res.solve.exemplars, ref.exemplars)
    np.testing.assert_array_equal(res.labels, ref.labels[0])
    snap = service.snapshot()
    assert snap["overflow_solves"] >= 1
    assert snap["compiled"] == compiled_before   # no cache growth



def test_overflow_cap_beats_auto_bucket_growth():
    """Even with auto bucketing on, n past max_bucket_n must not mint an
    enormous micro-batch executable — it overflows to the sparse path."""
    svc = ClusterService(config=CFG, auto_bucket=True, max_bucket_n=128,
                         overflow_k=16)
    x, _ = _blobs(300, seed=12)
    res = svc.solve_sync(x)
    assert res.bucket is None and res.solve.backend == "dense_topk"
    assert all(b.n <= 128 for b in svc.router.buckets)
    assert svc.snapshot()["overflow_solves"] == 1



def test_overflow_past_ceiling_escapes_to_coarsen():
    """An overflow request bigger than the dense_topk comfort ceiling
    (overflow_coarsen_n) runs as one two-level coarsen solve — counted
    separately, same response contract, still no compile-cache growth."""
    svc = ClusterService(config=SolveConfig(max_iterations=30,
                                            preference="median", levels=2,
                                            device="cpu"),
                         buckets=[(64, 2, 4)], auto_bucket=False,
                         overflow_coarsen_n=300)
    svc.warmup()
    x, _ = _blobs(400, seed=13)
    compiled_before = svc.snapshot()["compiled"]
    res = svc.solve_sync(x)
    assert res.path == "full" and res.bucket is None
    assert res.solve.backend == "coarsen"
    snap = svc.snapshot()
    assert snap["overflow_solves"] == 1
    assert snap["overflow_coarsen_solves"] == 1
    assert snap["compiled"] == compiled_before
    # below the ceiling the dense_topk route is untouched
    res2 = svc.solve_sync(_blobs(200, seed=14)[0])
    assert res2.solve.backend == "dense_topk"
    snap = svc.snapshot()
    assert snap["overflow_solves"] == 2
    assert snap["overflow_coarsen_solves"] == 1



def test_overflow_coarsen_disabled_with_none():
    svc = ClusterService(config=SolveConfig(max_iterations=30,
                                            preference="median", levels=2,
                                            device="cpu"),
                         buckets=[(64, 2, 4)], auto_bucket=False,
                         overflow_coarsen_n=None)
    svc.warmup()
    res = svc.solve_sync(_blobs(400, seed=13)[0])
    assert res.solve.backend == "dense_topk"
    assert svc.snapshot()["overflow_coarsen_solves"] == 0



def test_overflow_sampled_preference_is_deterministic(monkeypatch):
    """Past PREF_EXACT_N the overflow preference is the port's sampled
    estimate (ROADMAP C3: its own seeded draw, not the reference's):
    the same on every call, and within 3 % of the exact median."""
    from repro_torch.solver import topk
    from repro_torch.core.preferences import make_preferences
    from repro_torch.core.similarity import pairwise_similarity

    monkeypatch.setattr(topk, "PREF_EXACT_N", 256)
    svc = ClusterService(config=CFG, buckets=[(64, 2, 2)],
                         auto_bucket=False)
    x = _blobs(5000, seed=4)[0][::10]          # 500 points
    a = svc._overflow_preference(x)
    assert a == svc._overflow_preference(x)
    exact = float(make_preferences(
        pairwise_similarity(torch.from_numpy(x)), "median")[0])
    assert a == pytest.approx(exact, rel=0.03)



def test_drift_triggers_background_resolve():
    """Points far from every exemplar (best similarity < preference) push
    the drift EWMA over threshold -> a background full re-solve adopts
    the new region."""
    svc = ClusterService(config=CFG, buckets=[(128, 2, 2)],
                         auto_bucket=False, drift_threshold=0.25,
                         drift_halflife=16)
    svc.warmup()
    rng = np.random.default_rng(0)
    near = rng.normal(size=(60, 2)).astype(np.float32) * 0.3
    svc.solve_sync(near, stream="s")
    gen0 = svc.stream_info("s")["generation"]
    far = (rng.normal(size=(40, 2)) * 0.3 + 80.0).astype(np.float32)
    r = svc.solve_sync(far, stream="s")
    assert r.path == "assign"
    assert r.assign.drift == 1.0                   # all stale
    assert r.assign.resolve_triggered
    svc.drain()                                    # run the re-solve
    info = svc.stream_info("s")
    assert info["generation"] == gen0 + 1
    assert info["drift"] == 0.0                    # reset on install
    # the refreshed exemplar set now explains the far region
    r2 = svc.solve_sync(far, stream="s")
    assert r2.path == "assign" and r2.assign.drift == 0.0



def test_failed_resolve_releases_pending_flag(monkeypatch):
    """A drift re-solve that dies must clear resolve_pending so the next
    drift crossing can schedule a fresh one."""
    svc = ClusterService(config=CFG, buckets=[(128, 2, 2)],
                         auto_bucket=False, drift_threshold=0.2,
                         drift_halflife=8)
    svc.warmup()
    rng = np.random.default_rng(2)
    svc.solve_sync(rng.normal(size=(60, 2)).astype(np.float32),
                   stream="s")
    far = (rng.normal(size=(40, 2)) + 70.0).astype(np.float32)
    r = svc.submit(far, stream="s").result(timeout=10)
    assert r.assign.resolve_triggered
    # make the queued internal re-solve fail (the scheduler right-sizes
    # via lookup first — force it onto the failing get)
    def boom(bucket, cfg):
        raise RuntimeError("injected")
    monkeypatch.setattr(svc.cache, "lookup", lambda b, c: None)
    monkeypatch.setattr(svc.cache, "get", boom)
    svc.drain()
    assert svc.stream_info("s")["resolve_pending"] is False
    monkeypatch.undo()
    # next drift crossing schedules again and succeeds this time
    gen0 = svc.stream_info("s")["generation"]
    svc.submit(far, stream="s").result(timeout=10)
    svc.drain()
    assert svc.stream_info("s")["generation"] == gen0 + 1



def test_drift_resolve_recalibrates_preference_in_flight():
    """The drift trigger re-derives the stream preference from the
    buffered window *before* the background re-solve lands, so the
    drift test tracks the shifted data while the solve is in flight."""
    svc = ClusterService(config=CFG, buckets=[(128, 2, 2)],
                         auto_bucket=False, drift_threshold=0.25,
                         drift_halflife=16)
    svc.warmup()
    rng = np.random.default_rng(5)
    near = rng.normal(size=(60, 2)).astype(np.float32) * 0.3
    svc.solve_sync(near, stream="s")
    st = svc._streams["s"]
    pref0 = st.preference
    far = (rng.normal(size=(40, 2)) * 0.3 + 80.0).astype(np.float32)
    r = svc.solve_sync(far, stream="s")
    assert r.assign.resolve_triggered
    # recalibrated from the near+far window immediately at trigger time:
    # the mixed window spans two regions, so the median similarity is
    # far more negative than the tight near-only preference
    assert st.preference < pref0
    svc.drain()

