"""The port's clustering service (``repro_torch.serve.cluster``) on the
CPU: the tests of ``tests/test_cluster_serve.py`` on the port (buckets,
the compile cache, micro-batching, streams and the fast path, the
scheduler), the numpy-exact pieces against the reference (load
generator, Poisson gaps, window preference, trace-fitted buckets), and
the device rule (no card and no ``device="cpu"`` raises). The overflow
routes and drift re-solves are in ``test_torch_serve_overflow.py``, the
parity with the reference service in ``test_torch_serve_parity.py`` and
``test_torch_serve_points.py``; the shared fixtures in
``tests/_torch_serve.py``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_serve import CFG, RECORD, _blobs, service  # noqa: E402,F401
from repro_torch.serve.cluster import (  # noqa: E402
    Bucket, BucketRouter, ClusterService,
)
from repro_torch.solver import solve  # noqa: E402


def test_router_routes_to_smallest_fit():
    r = BucketRouter([(64, 2), (128, 2), (128, 4)], auto=False)
    assert r.route(50, 2) == Bucket(64, 2)
    assert r.route(64, 2) == Bucket(64, 2)
    assert r.route(65, 2) == Bucket(128, 2)
    assert r.route(65, 3) == Bucket(128, 4)   # feature dim pads up too
    assert r.route(500, 2) is None            # nothing fits, auto off



def test_router_auto_grows_power_of_two():
    r = BucketRouter([(64, 2)], auto=True, default_batch=2)
    b = r.route(300, 2)
    assert b == Bucket(512, 2, 2)
    assert b in r.buckets                      # registered for reuse
    assert r.route(400, 2) == b



def test_pad_points_zero_fills():
    pts = np.ones((3, 2), np.float32)
    out = BucketRouter.pad_points(pts, Bucket(8, 4))
    assert out.shape == (8, 4)
    assert np.all(out[:3, :2] == 1) and out.sum() == 6



def test_feature_dim_padding_preserves_clustering(service):
    """Zero feature columns leave pairwise distances unchanged, so a
    (n, 1) request through a (., 2) bucket solves exactly like the
    unpadded 1-D data."""
    rng = np.random.default_rng(5)
    x = np.asarray(np.concatenate([rng.normal(0.0, 0.1, 20),
                                   rng.normal(9.0, 0.1, 20)]
                                  ).reshape(-1, 1), np.float32)
    res = service.solve_sync(x)
    ref = solve(x, backend="dense_parallel", stop="converged",
                max_iterations=80, damping=0.6, levels=2,
                preference="median", device="cpu")
    assert res.bucket == (64, 2, 4)
    np.testing.assert_array_equal(res.solve.exemplars, ref.exemplars)
    np.testing.assert_array_equal(res.solve.n_clusters, ref.n_clusters)



def test_warmup_compiles_once_per_bucket_variant():
    svc = ClusterService(config=CFG, buckets=[(64, 2, 2)],
                         auto_bucket=False)
    d1 = svc.warmup()
    # batch ladder: one executable per power-of-two variant (1, 2)
    assert d1["hits"] == 0 and d1["misses"] == 2
    assert d1["compile_seconds"] > 0
    d2 = svc.warmup()
    assert d2["misses"] == 0 and d2["hits"] == 2



def test_warmup_without_ladder_compiles_full_batch_only():
    svc = ClusterService(config=CFG, buckets=[(64, 2, 2)],
                         auto_bucket=False, batch_ladder=False)
    d1 = svc.warmup()
    assert d1["hits"] == 0 and d1["misses"] == 1



def test_padded_bucket_solve_bit_matches_engine(service):
    """A request padded into a bucket (inert dummy rows) must reproduce
    the unpadded solve() exemplars exactly — same contract as the
    distributed mesh padding round-trip."""
    x, _ = _blobs(50, seed=3)
    res = service.solve_sync(x)
    ref = solve(x, backend="dense_parallel", stop="converged",
                max_iterations=80, damping=0.6, levels=2,
                preference="median", device="cpu")
    assert res.path == "full" and res.bucket == (64, 2, 4)
    np.testing.assert_array_equal(res.solve.exemplars, ref.exemplars)
    np.testing.assert_array_equal(res.solve.labels, ref.labels)



def test_micro_batch_riders_match_solo_runs(service):
    """Requests sharing one vmapped executable get the same answers as
    requests run alone."""
    xs = [_blobs(n, seed=s)[0] for n, s in [(40, 1), (55, 2), (64, 3)]]
    futs = [service.submit(x) for x in xs]
    before = service.snapshot()["micro_batches"]
    service.drain()
    assert service.snapshot()["micro_batches"] == before + 1  # one batch
    for x, f in zip(xs, futs):
        ref = solve(x, backend="dense_parallel", stop="converged",
                    max_iterations=80, damping=0.6, levels=2,
                    preference="median", device="cpu")
        np.testing.assert_array_equal(f.result().solve.exemplars,
                                      ref.exemplars)



def test_unroutable_rejects_only_when_overflow_off():
    svc = ClusterService(config=CFG, buckets=[(64, 2, 4)],
                         auto_bucket=False, overflow="reject")
    fut = svc.submit(np.zeros((500, 2), np.float32))
    with pytest.raises(ValueError, match="no bucket fits"):
        fut.result(timeout=5)



def test_explicit_large_bucket_beats_overflow():
    """A provisioned bucket larger than max_bucket_n still routes — the
    cap bounds auto-growth, never explicitly warmed executables."""
    svc = ClusterService(config=CFG, buckets=[(512, 2, 4)],
                         auto_bucket=False, max_bucket_n=128)
    svc.submit(np.zeros((300, 2), np.float32))
    queued = [key for w in svc.workers for key in w.queues]
    overflow = sum(len(w.overflow) for w in svc.workers)
    assert queued == [(512, 2, 4)] and overflow == 0



def test_auto_growth_respects_cap_for_non_pow2():
    """Power-of-two growth must not mint an executable above the cap."""
    r = BucketRouter([], auto=True)
    assert r.route(2500, 2, max_grow_n=3000) is None
    assert r.route(2500, 2).n == 4096      # uncapped growth unchanged



def test_single_point_request_is_trivial(service):
    res = service.solve_sync(np.zeros((1, 2), np.float32))
    assert res.labels.tolist() == [0]



def test_incremental_matches_fresh_solve_assignment():
    """Fast-path labels against the stream exemplar set must agree with a
    fresh solve() on the same points (well-separated data: AP assignment
    == nearest exemplar)."""
    svc = ClusterService(config=CFG, buckets=[(128, 2, 2)],
                         auto_bucket=False)
    svc.warmup()
    x, _ = _blobs(120, seed=11, spread=0.25)
    full = svc.solve_sync(x, stream="st")
    fast = svc.solve_sync(x, stream="st")          # same points again
    assert full.path == "full" and fast.path == "assign"
    fresh = solve(x, backend="dense_parallel", stop="converged",
                  max_iterations=80, damping=0.6, levels=2,
                  preference="median", device="cpu")
    # the exemplar *point coordinates* each point lands on must agree
    fresh_ex_coords = x[fresh.exemplars[0]]
    fast_ex_coords = fast.assign.exemplar_points[fast.labels]
    np.testing.assert_allclose(fast_ex_coords, fresh_ex_coords)
    assert fast.assign.drift == 0.0                # in-distribution



def test_assign_mode_requires_seeded_stream(service):
    fut = service.submit(np.zeros((8, 2), np.float32), stream="virgin",
                         mode="assign")
    with pytest.raises(RuntimeError, match="no exemplar set"):
        fut.result(timeout=5)



def test_resolve_working_set_capped_by_buckets():
    """A drift re-solve never creates a new bucket shape: the working set
    is clipped to the largest bucket, so no request-path compile."""
    svc = ClusterService(config=CFG, buckets=[(64, 2, 2)],
                         auto_bucket=True, drift_threshold=0.1,
                         drift_halflife=4)
    svc.warmup()
    rng = np.random.default_rng(1)
    svc.solve_sync(rng.normal(size=(60, 2)).astype(np.float32),
                   stream="s")
    misses = svc.snapshot()["cache"]["misses"]
    for step in range(3):                          # overflow the buffer
        far = (rng.normal(size=(50, 2)) + 50.0 * (step + 1)).astype(
            np.float32)
        svc.submit(far, stream="s").result(timeout=10)
        svc.drain()
    assert svc.snapshot()["cache"]["misses"] == misses
    assert [b.key for b in svc.router.buckets] == [(64, 2, 2)]



def test_e2e_warm_service_mixed_stream_zero_recompiles():
    """The acceptance scenario: a warmed service takes a mixed stream of
    >= 50 requests across >= 2 shape buckets — full solves and
    incremental assignments interleaved — with ZERO compiles after
    warmup (compile-cache miss counter flat), and incremental results
    agreeing with fresh solve() assignments."""
    svc = ClusterService(config=CFG, buckets=[(64, 2, 4), (128, 2, 4)],
                         auto_bucket=False)
    warm = svc.warmup()
    assert warm["misses"] == 6     # per bucket: ladder variants 1, 2, 4
    base, _ = _blobs(100, seed=21, spread=0.25)
    svc.solve_sync(base, stream="e2e")             # seed the stream

    rng = np.random.default_rng(7)
    futs, checks = [], []
    for i in range(50):
        if i % 3 == 0:                             # incremental rider
            sel = rng.choice(len(base), size=30, replace=False)
            futs.append(svc.submit(base[sel], stream="e2e"))
            checks.append(("assign", base[sel]))
        else:                                      # full solve rider
            n = int(rng.integers(24, 120))
            x, _ = _blobs(n, seed=100 + i)
            futs.append(svc.submit(x))
            checks.append(("full", x))
    svc.drain()

    snap = svc.snapshot()
    assert snap["cache"]["misses"] == 6            # zero recompiles
    assert snap["cache"]["hits"] >= snap["micro_batches"]
    assert snap["requests"] >= 51
    assert snap["fast_assigns"] >= 16
    assert len(snap["buckets"]) == 2

    fresh = solve(base, backend="dense_parallel", stop="converged",
                  max_iterations=80, damping=0.6, levels=2,
                  preference="median", device="cpu")
    for (kind, pts), fut in zip(checks, futs):
        res = fut.result(timeout=30)
        assert res.path == kind
        assert res.labels.shape == (len(pts),)
        if kind == "assign":
            # incremental assignment == fresh solve's exemplar choice
            idx = [np.flatnonzero((base == p).all(1))[0] for p in pts]
            want = base[fresh.exemplars[0][idx]]
            got = res.assign.exemplar_points[res.labels]
            np.testing.assert_allclose(got, want)



def test_service_rejects_topk_k_config():
    """The batched dense path would silently ignore SolveConfig.k."""
    with pytest.raises(ValueError, match="dense_topk knob"):
        ClusterService(config=CFG.replace(k=16))



def test_streams_require_sqeuclidean_metric():
    """Fast-path assignment/drift are -||.||^2 quantities; other metrics
    must be rejected at submit, not silently mis-assigned."""
    svc = ClusterService(config=CFG.replace(metric="cosine"),
                         buckets=[(64, 2, 2)], auto_bucket=False)
    with pytest.raises(ValueError, match="neg_sqeuclidean"):
        svc.submit(np.zeros((8, 2), np.float32), stream="s")



def test_threaded_scheduler_drains_queue():
    """start()/stop(): the background thread batches and completes
    everything without explicit drain() calls."""
    svc = ClusterService(config=CFG, buckets=[(64, 2, 4)],
                         auto_bucket=False, max_wait_ms=1.0)
    svc.warmup()
    svc.start()
    try:
        xs = [_blobs(40, seed=s)[0] for s in range(8)]
        futs = [svc.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            res = f.result(timeout=60)
            assert res.path == "full" and res.labels.shape == (len(x),)
    finally:
        svc.stop()
    assert svc.snapshot()["cache"]["misses"] == 3  # warmup ladder only



def test_window_preference_matches_full_median():
    from repro_torch.serve.cluster.incremental import window_preference
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(40, 2)).astype(np.float32)
    sq = np.einsum("nd,nd->n", pts, pts)
    s = 2.0 * pts @ pts.T - sq[:, None] - sq[None, :]
    off = s[~np.eye(40, dtype=bool)]
    assert window_preference(pts, "median") == pytest.approx(
        float(np.median(off)))
    assert window_preference(pts, "range_mid") == pytest.approx(
        float(0.5 * (off.min() + off.max())))
    # non-derived strategies must not float between solves
    assert window_preference(pts, -5.0) is None
    assert window_preference(pts, "constant") is None
    assert window_preference(pts[:1], "median") is None



def test_stream_recalibrate_tracks_scale_shift():
    from repro_torch.serve.cluster.incremental import StreamState
    st = StreamState("s")
    rng = np.random.default_rng(1)
    assert not st.recalibrate("median")            # empty buffer no-op
    st.absorb(rng.normal(size=(50, 2)).astype(np.float32) * 0.3)
    st.preference = -1e9                           # stale yardstick
    assert st.recalibrate("median")
    tight = st.preference
    assert tight > -1e9
    # wider data -> similarities spread -> preference drops again
    st.absorb(rng.normal(size=(200, 2)).astype(np.float32) * 10.0)
    assert st.recalibrate("median", window=200)
    assert st.preference < tight
    # numeric strategy: never recalibrated
    st.preference = -7.0
    assert not st.recalibrate(-7.0)
    assert st.preference == -7.0



def test_synthetic_requests_and_gaps_match_the_reference_bit_for_bit():
    from repro.serve.cluster import loadgen as ref_loadgen
    from repro_torch.serve.cluster import loadgen

    shapes = [(128, 2), (256, 2), (512, 2)]
    want = ref_loadgen.synthetic_requests(12, shapes, seed=5)
    got = loadgen.synthetic_requests(12, shapes, seed=5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()

    class Recorder:
        """Stands in for a service: records what ``_offer`` submits."""
        def __init__(self):
            self.calls = []

        def submit(self, pts, **kw):
            self.calls.append((pts.shape, kw["stream"]))
            raise ServiceOverloadedError("recorded")

    from repro_torch.serve.cluster import ServiceOverloadedError
    seen = {}
    for name, mod in (("ref", ref_loadgen), ("port", loadgen)):
        rec, records = Recorder(), []
        mod._offer(rec, got, rps=1e6, stream="s", stream_frac=0.5, seed=9,
                   deadline_ms=None, records=records)
        seen[name] = rec.calls
    assert seen["port"] == seen["ref"]
    rng_ref = np.random.default_rng(9)
    assert np.array_equal(rng_ref.exponential(1e-6, size=12),
                          np.random.default_rng(9).exponential(
                              1e-6, size=12))



@pytest.mark.parametrize("strategy", ["median", "range_mid"])
@pytest.mark.parametrize("n", [40, 1500])
def test_window_preference_matches_the_reference_bit_for_bit(strategy, n):
    from repro.serve.cluster.incremental import (
        window_preference as ref_window,
    )
    from repro_torch.serve.cluster.incremental import window_preference

    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    for seed in (0, 3):
        got = window_preference(pts, strategy, seed=seed)
        assert got == ref_window(pts, strategy, seed=seed)



def test_from_trace_reads_the_repo_record_into_the_reference_table():
    from repro.serve.cluster import ClusterService as JService
    from repro.serve.cluster.traffic import fit_buckets as ref_fit
    from repro.serve.cluster.traffic import mine_trace as ref_mine
    from repro_torch.serve.cluster import fit_buckets, mine_trace

    assert mine_trace(str(RECORD)) == ref_mine(str(RECORD))
    for budget in (1, 2, 4):
        assert fit_buckets(mine_trace(str(RECORD)), max_buckets=budget) \
            == ref_fit(ref_mine(str(RECORD)), max_buckets=budget)
    port = ClusterService.from_trace(str(RECORD), config=CFG)
    ref = JService.from_trace(str(RECORD))
    assert [b.key for b in port.router.buckets] == [
        b.key for b in ref.router.buckets]
    assert port.router.auto is ref.router.auto is False
    with open(RECORD) as fh:
        assert mine_trace(json.load(fh)) == mine_trace(str(RECORD))



def test_service_needs_a_card_unless_it_is_told_cpu(monkeypatch):
    """No CUDA and no device="cpu": the service, its handles and the
    driver raise; nothing falls back to the CPU."""
    from repro_torch.launch import cluster_serve
    from repro_torch.solver.compiled import BatchedDenseSolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = CFG.replace(device=None)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ClusterService(config=base.replace(device=device))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedDenseSolver(2, 8, 2, base)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cluster_serve.main(["--smoke"])
    svc = ClusterService(config=CFG, buckets=[(64, 2, 2)])
    assert {w.device for w in svc.workers} == {torch.device("cpu")}
    assert BatchedDenseSolver(2, 8, 2, base, device="cpu").device.type \
        == "cpu"



def test_workers_round_robin_over_the_cards(monkeypatch):
    from repro_torch.serve.cluster.service import _worker_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert _worker_devices(3) == [torch.device("cuda", i)
                                  for i in (0, 1, 0)]
    assert _worker_devices(3, "cuda") == _worker_devices(3)
    assert _worker_devices(2, "cuda:1") == [torch.device("cuda:1")] * 2
    assert _worker_devices(2, "cpu") == [torch.device("cpu")] * 2



def test_cache_key_names_the_handle_device():
    from repro_torch.serve.cluster import CompileCache

    cache = CompileCache(device=torch.device("cpu"))
    handle = cache.get(Bucket(64, 2, 1), CFG.replace(device=None))
    assert handle.device == torch.device("cpu")
    assert cache.key(Bucket(64, 2, 1), CFG.replace(device=None)) \
        == cache.key(Bucket(64, 2, 1), CFG)
    assert cache.key(Bucket(64, 2, 1), CFG)[1][-1] == "cpu"



def test_driver_smoke_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import cluster_serve

    out = tmp_path / "serve.json"
    assert cluster_serve.main(["--smoke", "--device", "cpu",
                               "--stream-frac", "0.5",
                               "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "0 errors" in text and "handles" in text
    rec = json.loads(out.read_text())
    assert rec["rows"][0]["n_requests"] == 24
    assert sum(rec["rows"][0]["shape_counts"].values()) == 24
    assert rec["rows"][0]["fast_frac"] > 0

