"""The port's clustering service (``repro_torch.serve.cluster``) on the
CPU: each test of ``tests/test_cluster_serve.py`` on the port, then
parity with the reference service on the same requests, the numpy-exact
pieces (load generator, Poisson gaps, window preference, trace-fitted
buckets), and the device rule (no card and no ``device="cpu"`` raises).

Parity runs both services with ``drain()``, so no threads run. The port
builds S with PyTorch's arithmetic and the reference with XLA's, which
contracts multiply-adds (ROADMAP C2), so the strict parity test feeds
the port the reference's similarity values: from the same S, every
decision, trace and counter must be equal. From points, the decisions of
converged solves must be equal too, and the traces agree within C2's
allowance.
"""
import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import gaussian_blobs  # noqa: E402
from repro_torch.serve.cluster import (  # noqa: E402
    Bucket, BucketRouter, ClusterService,
)
from repro_torch.solver import SolveConfig, solve  # noqa: E402

CFG = SolveConfig(stop="converged", max_iterations=80, damping=0.6,
                  levels=2, preference="median", device="cpu")
RECORD = (Path(__file__).resolve().parents[1] / "benchmarks" / "records"
          / "serve_scaleout_full.json")


@pytest.fixture(scope="module")
def service():
    svc = ClusterService(config=CFG, buckets=[(64, 2, 4), (128, 2, 4)],
                         auto_bucket=False)
    svc.warmup()
    return svc


def _blobs(n, seed, spread=0.3):
    x, y = gaussian_blobs(n=n, k=4, seed=seed, spread=spread, box=14.0)
    return x, y


# ---------------------------------------------------------------- buckets
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


# ---------------------------------------------------- compile cache + parity
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


# --------------------------------------------------------- big-N overflow
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


def test_single_point_request_is_trivial(service):
    res = service.solve_sync(np.zeros((1, 2), np.float32))
    assert res.labels.tolist() == [0]


# ------------------------------------------------------------- incremental
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


# ------------------------------------------------------------- end-to-end
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


# ------------------------------------------------- preference recalibration
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


# ------------------------------------------- parity with the reference
PARITY_KW = dict(stop="converged", max_iterations=80, damping=0.6,
                 levels=2, preference="median")
SERVICE_KW = dict(buckets=[(64, 2, 4), (128, 2, 4)], auto_bucket=False,
                  max_bucket_n=128, drift_halflife=16)


def _parity_services(**kw):
    """The same service, one of each package: JAX on the CPU, the port
    with device="cpu"."""
    from repro.serve.cluster import ClusterService as JService
    from repro.solver import SolveConfig as JConfig

    svc_kw = {**SERVICE_KW, **kw}
    ref = JService(config=JConfig(**PARITY_KW), **svc_kw)
    port = ClusterService(config=SolveConfig(**PARITY_KW, device="cpu"),
                          **svc_kw)
    return ref, port


def _parity_traffic(seed: int, overflow_stream: Optional[str] = "big"):
    """Seeded numpy requests: plain and stream-tagged micro-batch riders
    in both buckets, two overflow requests (N = 500 on stream
    ``overflow_stream``, N = 300 plain; max_bucket_n = 128), a single
    point; then, once the streams hold exemplars, fast-path riders, far
    points that push stream "a" past the drift threshold (its re-solve
    runs in the second drain) and a request whose deadline has already
    passed."""
    rng = np.random.default_rng(seed)
    first = []
    for i in range(10):
        n = int(rng.integers(20, 129))
        x, _ = gaussian_blobs(n=n, k=4, seed=seed * 100 + i, spread=0.3,
                              box=14.0)
        first.append((x, "a" if i % 3 == 0 else None, None))
    first.append((_blobs(500, seed=seed + 11)[0], overflow_stream, None))
    first.append((_blobs(300, seed=seed + 12)[0], None, None))
    first.append((np.zeros((1, 2), np.float32), None, None))
    base = first[0][0]
    far = (rng.normal(size=(60, 2)) * 0.3 + 80.0).astype(np.float32)
    second = [(base[:30], "a", None),
              (first[10][0][:50], overflow_stream, None),
              (far, "a", None), (_blobs(40, seed=seed + 13)[0], None, None),
              (base, None, 0.0)]
    return first, second


def _drive(svc, first, second):
    futs = [svc.submit(x, stream=s, deadline_ms=dl) for x, s, dl in first]
    svc.drain()
    futs += [svc.submit(x, stream=s, deadline_ms=dl)
             for x, s, dl in second]
    svc.drain()
    return [f.exception(timeout=60) or f.result() for f in futs]


def _counters(svc) -> dict:
    """Every ``ServiceStats`` field, and the cache's hits and misses
    (``compile_seconds`` is a time, not a counter)."""
    snap = svc.snapshot()
    out = {f.name: snap[f.name]
           for f in dataclasses.fields(type(svc.stats)) if f.name != "cache"}
    out["cache"] = {k: snap["cache"][k] for k in ("hits", "misses")}
    out["buckets"], out["compiled"] = snap["buckets"], snap["compiled"]
    return out


def _assert_same_responses(ref_out, port_out, *, same_s: bool,
                           pref_rel: float):
    """Every response alike. Decisions are exact, with two known
    differences (ROADMAP C2): the top-k sweeps' level sums round
    differently from XLA's, so a ``dense_topk`` trace may differ by a
    point or two a sweep even from the same S; and from points (``same_s``
    False) a solve that has not converged by ``max_iterations`` (top-k AP
    on blobs oscillates) follows the drift of S, so only its sweep count
    and flag are compared, and every trace may differ by a point or two
    a sweep (a border point or an inert padding row)."""
    assert len(ref_out) == len(port_out)
    for i, (want, got) in enumerate(zip(ref_out, port_out)):
        if isinstance(want, BaseException):
            assert type(got).__name__ == type(want).__name__, i
            continue
        assert (got.path, got.bucket, got.stream, got.generation) == (
            want.path, want.bucket, want.stream, want.generation), i
        settled = same_s or want.solve is None or want.solve.converged
        if settled:
            np.testing.assert_array_equal(got.labels, want.labels)
        if want.path == "assign":
            assert got.assign.drift == want.assign.drift
            assert (got.assign.resolve_triggered
                    == want.assign.resolve_triggered)
            np.testing.assert_array_equal(got.assign.exemplar_points,
                                          want.assign.exemplar_points)
            np.testing.assert_allclose(got.assign.best_sim,
                                       want.assign.best_sim,
                                       rtol=pref_rel, atol=1e-4)
            continue
        if want.solve is None:                 # the single point
            assert got.solve is None
            continue
        assert got.solve.backend == want.solve.backend
        assert got.solve.n_sweeps == want.solve.n_sweeps, i
        assert got.solve.converged == want.solve.converged, i
        if not settled:
            continue
        np.testing.assert_array_equal(got.solve.exemplars,
                                      want.solve.exemplars)
        if same_s and want.solve.backend != "dense_topk":
            np.testing.assert_array_equal(got.solve.trace,
                                          want.solve.trace)
        else:
            assert len(got.solve.trace) == len(want.solve.trace)
            assert np.abs(got.solve.trace.astype(np.int64)
                          - want.solve.trace).max(initial=0) <= 2, i


def _assert_same_streams(ref, port, pref_rel: float, streams=("a", "big")):
    for stream in streams:
        want, got = ref.stream_info(stream), port.stream_info(stream)
        assert got.pop("preference") == pytest.approx(
            want.pop("preference"), rel=pref_rel)
        assert got == want


@pytest.fixture
def reference_similarity(monkeypatch):
    """Feed the port the reference's similarity values: the batched
    handle's S and the top-k build's values come from the JAX functions
    on the same points. Everything downstream is the port's."""
    import jax.numpy as jnp

    from repro.core.similarity import pairwise_similarity as ref_sim
    from repro.solver.config import SolveConfig as JConfig
    from repro.solver.topk_build import build_topk_similarity as ref_build
    from repro_torch.solver import compiled, topk, topk_build

    def sim(x, metric="neg_sqeuclidean"):
        s = ref_sim(jnp.asarray(x.numpy()), metric=metric)
        return torch.from_numpy(np.array(s))

    def build(x, k, cfg):
        vals, idx = ref_build(jnp.asarray(x.numpy()), k,
                              JConfig(metric=cfg.metric))
        return (torch.from_numpy(np.array(vals)),
                torch.from_numpy(np.array(idx)))

    monkeypatch.setattr(compiled, "pairwise_similarity", sim)
    monkeypatch.setattr(topk, "build_topk_similarity", build)
    monkeypatch.setattr(topk_build, "build_topk_similarity", build)


def test_service_parity_from_the_same_similarities(reference_similarity):
    """From the reference's S, the port's service answers the mixed
    traffic exactly as the reference's does: labels, exemplars, sweeps,
    flags, traces, paths, buckets, stream generations, every counter and
    the stream preferences."""
    ref, port = _parity_services()
    assert ref.warmup()["misses"] == port.warmup()["misses"] == 6
    first, second = _parity_traffic(seed=1)
    ref_out, port_out = (_drive(ref, first, second),
                         _drive(port, first, second))
    _assert_same_responses(ref_out, port_out, same_s=True, pref_rel=1e-6)
    _assert_same_streams(ref, port, pref_rel=1e-6)
    assert _counters(port) == _counters(ref)
    counters = _counters(port)
    assert counters["overflow_solves"] == 2
    assert counters["resolves_triggered"] == 1
    assert counters["deadline_rejects"] == 1
    assert counters["fast_assigns"] == 3


@pytest.mark.parametrize("seed", [2, 3])
def test_service_decisions_match_the_reference_from_points(seed):
    """From points (each package builds its own S): the same paths,
    buckets, generations and counters, equal decisions of every solve
    that converged, and traces within C2's allowance. The N = 500
    overflow rides no stream here: its top-k solve does not converge in
    80 sweeps, so its exemplars follow the drift of S, and a stream would
    install them."""
    ref, port = _parity_services()
    ref.warmup()
    port.warmup()
    first, second = _parity_traffic(seed=seed, overflow_stream=None)
    _assert_same_responses(_drive(ref, first, second),
                           _drive(port, first, second),
                           same_s=False, pref_rel=1e-4)
    _assert_same_streams(ref, port, pref_rel=1e-4, streams=("a",))
    assert _counters(port) == _counters(ref)


def test_overflow_parity_with_the_reference(reference_similarity):
    """N = 500 past a lowered max_bucket_n: the exact-preference branch
    (N <= PREF_EXACT_N) of both packages; from the same top-k values the
    dense_topk decisions, trace and the stream's installed preference
    are the reference's."""
    ref, port = _parity_services(max_bucket_n=64)
    x = _blobs(500, seed=11)[0]
    want = ref.solve_sync(x, stream="o")
    got = port.solve_sync(x, stream="o")
    assert got.solve.backend == want.solve.backend == "dense_topk"
    _assert_same_responses([want], [got], same_s=True, pref_rel=1e-6)
    assert port.stream_info("o") == ref.stream_info("o")
    assert _counters(port) == _counters(ref)


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


# ------------------------------------------------------- numpy-exact parts
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


# ------------------------------------------------------------ device rule
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
