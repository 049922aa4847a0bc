"""The port's ``coarsen`` backend and batched dense handle on the CPU
against the JAX reference (``tests/test_coarsen.py`` is the oracle).

Decisions (exemplars, labels, n_clusters, n_sweeps, converged) must equal
the reference's. Every case keeps the exemplar union E <= 4,096 (or a
scalar preference), so the global preference is the exact statistic in
both packages and the port's sampled median (``ROADMAP.md`` C3) never
enters. Each package builds its own similarities (C2); these inputs are
separated well enough that no decision sits on such a tie. The batched
handle has no reference test of its own: it is held against the
reference's handle on the same arrays and against the port's unpadded
dense solves.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.similarity import pairwise_similarity as j_pairwise  # noqa: E402
from repro.data import gaussian_blobs  # noqa: E402
from repro.solver import solve as j_solve  # noqa: E402
from repro_torch.core.metrics import purity  # noqa: E402
from repro_torch.solver import SolveConfig, solve  # noqa: E402
from repro_torch.solver import coarsen, compiled, registry  # noqa: E402
from repro_torch.solver.registry import auto_select, get_backend  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run thousands of small PyTorch ops; beside the suite's
    other parallel workers, intra-op threads oversubscribe the cores and
    slow each op tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(n, seed=0, k=6, dim=8):
    return gaussian_blobs(n=n, k=k, dim=dim, seed=seed, spread=0.3,
                          box=20.0)


def _same(got, want, sweeps=True):
    np.testing.assert_array_equal(got.exemplars, want.exemplars)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.n_clusters, want.n_clusters)
    assert got.converged == want.converged
    if sweeps:
        assert got.n_sweeps == want.n_sweeps


def _both(x, **kw):
    got = solve(x, backend="coarsen", device="cpu", **kw)
    want = j_solve(x, backend="coarsen", **kw)
    assert got.backend == want.backend == "coarsen"
    return got, want


# ------------------------------------------------- single-partition oracle
@pytest.mark.parametrize("stop,max_it", [("fixed", 40), ("converged", 150)])
def test_single_partition_is_the_dense_oracle(stop, max_it):
    x, _ = _blobs(300, seed=1 if stop == "fixed" else 2)
    got, want = _both(x, partition_size=512, stop=stop, max_iterations=max_it)
    _same(got, want)
    oracle = solve(x, backend="dense_parallel", stop=stop,
                   max_iterations=max_it, device="cpu")
    _same(got, oracle)
    np.testing.assert_array_equal(got.trace, oracle.trace)
    if stop == "converged":
        assert got.converged


# ------------------------------------------------------- multi-partition
@pytest.mark.parametrize("seed,kw", [
    (0, dict(partition_size=128, max_iterations=40)),
    (3, dict(partition_size=128, max_iterations=40)),
    (0, dict(partition_size=128, stop="converged", max_iterations=200)),
    (0, dict(partition_size=128, max_iterations=40, preference=-50.0)),
    (0, dict(partition_size=128, max_iterations=40, preference="range_mid")),
    # the global stage on dense_topk with k = min(16, E - 1)
    (0, dict(partition_size=128, max_iterations=40,
             coarsen_global_dense_n=2, coarsen_global_k=16)),
    (4, dict(partition_size=100, max_iterations=30, levels=1,
             coarsen_batch=3)),
])
def test_multi_partition_matches_reference(seed, kw):
    x, _ = _blobs(600, seed=seed)
    got, want = _both(x, **kw)
    _same(got, want)
    assert got.trace.shape == (0,)


def test_multi_partition_quality_and_canonical_output():
    x, y = _blobs(600, seed=0)
    res = solve(x, backend="coarsen", partition_size=128, max_iterations=40,
                device="cpu")
    for l in range(res.levels):
        assert purity(res.labels[l], y) > 0.85
        e = res.exemplars[l]
        np.testing.assert_array_equal(e[e], e)
        uniq = np.unique(e)
        assert res.n_clusters[l] == len(uniq)
        np.testing.assert_array_equal(uniq[res.labels[l]], e)
    assert 2 <= res.n_clusters[0] <= 24


def test_multi_partition_converged_stop_reports():
    x, _ = _blobs(600, seed=0)
    res = solve(x, backend="coarsen", partition_size=128, stop="converged",
                max_iterations=200, device="cpu")
    assert res.converged is True and 0 < res.n_sweeps < 200


def test_duplicate_heavy_input_collapses_to_distinct_points():
    rng = np.random.default_rng(0)
    base = (rng.normal(size=(4, 5)) * 10.0).astype(np.float32)
    x = np.repeat(base, 250, axis=0)
    got, want = _both(x, partition_size=64, max_iterations=30)
    _same(got, want)
    assert got.n_clusters[0] == 4
    lab = got.labels[0].reshape(4, 250)
    assert all(len(np.unique(row)) == 1 for row in lab)


def test_size_one_cells_are_their_own_exemplars():
    x, _ = _blobs(9, seed=4, k=3, dim=2)
    got, want = _both(x, partition_size=2, max_iterations=30)
    _same(got, want)
    for l in range(got.levels):
        e = got.exemplars[l]
        np.testing.assert_array_equal(e[e], e)


def test_trivial_single_point():
    x = np.zeros((1, 3), np.float32)
    got, want = _both(x, input_kind="points")
    _same(got, want)
    np.testing.assert_array_equal(got.exemplars, np.zeros((3, 1), np.int32))


# --------------------------------------------------- validation + routing
@pytest.mark.parametrize("bad", [
    dict(partition_size=1), dict(coarsen_batch=0),
    dict(coarsen_global_dense_n=1), dict(coarsen_global_k=0),
    dict(preference="random"), dict(preference=np.full((16,), -1.0)),
])
def test_rejects_what_the_reference_rejects(bad):
    x = np.zeros((16, 2), np.float32)
    with pytest.raises(ValueError) as want:
        j_solve(x, backend="coarsen", **bad)
    with pytest.raises(ValueError) as got:
        solve(x, backend="coarsen", device="cpu", **bad)
    assert str(got.value) == str(want.value)


def test_registered_spec_needs_points():
    spec = get_backend("coarsen")
    assert spec.needs_points and spec.supports_early_stop
    x, _ = _blobs(64, seed=5)
    s = np.asarray(j_pairwise(jnp.asarray(x)))
    with pytest.raises(ValueError, match="raw points"):
        solve(s, backend="coarsen", device="cpu")


def test_checkpointing_waits_for_the_fault_tolerance_slice(tmp_path):
    """Pinned the refusal of a checkpointed coarsen solve until the
    fault-tolerance slice ported it; now the checkpointed solve equals
    the plain one and leaves the reference's stage artifacts
    (``tests/test_torch_checkpoint.py`` crashes and resumes it)."""
    x, _ = _blobs(300, seed=5)
    kw = dict(backend="coarsen", partition_size=64, device="cpu")
    plain = solve(x, **kw)
    ckpt = solve(x, checkpoint_every=1, checkpoint_dir=str(tmp_path), **kw)
    _same(ckpt, plain)
    assert sorted(os.listdir(tmp_path)) == ["global", "local",
                                            "solve_meta.json"]


def test_auto_select_names_are_registered():
    """C1: every backend a one-device call can route to is registered."""
    cfg = SolveConfig()
    names = set(registry.list_backends())
    for n, levels, has_points in [(96, 3, True), (9000, 3, True),
                                  (9000, 1, True), (600_000, 3, True),
                                  (600_000, 3, False)]:
        for platform in ("cuda", "cpu"):
            assert auto_select(n, levels, n_devices=1, has_points=has_points,
                               platform=platform, cfg=cfg) in names


@pytest.mark.parametrize("preference", ["median", -30.0])
def test_default_solve_routes_very_big_point_sets_to_coarsen(preference,
                                                             monkeypatch):
    """C1, second half: with N >= COARSEN_THRESHOLD points and the median
    or a scalar preference, ``solve(x)`` runs ``coarsen`` (it raised
    KeyError before the backend was registered); the threshold is lowered
    to keep the solve small, as the reference's test does not need to."""
    monkeypatch.setattr(registry, "COARSEN_THRESHOLD", 600)
    x, _ = _blobs(600, seed=0)
    got = solve(x, device="cpu", max_iterations=40, partition_size=128,
                preference=preference)
    assert got.backend == "coarsen"
    want = j_solve(x, backend="coarsen", max_iterations=40,
                   partition_size=128, preference=preference)
    _same(got, want)


# --------------------------------------------------------- batched handle
def test_run_before_compile_raises_and_handles_are_cached():
    cfg = SolveConfig(backend="dense_parallel", device="cpu")
    h = compiled.BatchedDenseSolver(2, 8, 3, cfg)
    with pytest.raises(RuntimeError, match="before compile"):
        h.run(np.zeros((2, 8, 3), np.float32), np.array([8, 8], np.int32))
    coarsen._HANDLES.clear()
    a = coarsen._local_handle(2, 8, 3, cfg)
    assert coarsen._local_handle(2, 8, 3, cfg) is a and a.compiled
    assert coarsen._local_handle(2, 8, 3, cfg.replace(damping=0.5)) is not a
    assert len(coarsen._HANDLES) == 2
    with pytest.raises(ValueError, match="dense family"):
        compiled.batched_order("dense_topk")
    with pytest.raises(ValueError, match="request data"):
        compiled.config_static_key(cfg.replace(preference=np.zeros(8)))


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("stop", ["fixed", "converged"])
@pytest.mark.parametrize("order", ["dense_parallel", "dense_sequential"])
@pytest.mark.parametrize("preference", ["median", "range_mid", -20.0])
def test_padded_batch_matches_the_reference_handle(levels, stop, order,
                                                   preference):
    """Requests of 30, 41 and 17 points in a bucket of 48, beside an inert
    filler slot (n_real = 2): exemplars, sweep counts, flags, traces and
    calibrated preferences equal the reference handle's on the same
    arrays. Each request also gives its own unpadded solve's decisions,
    where the reference does: at one level (coarsen's local solves) and
    under fixed stopping. At two levels under converged stopping the
    dummy rows' upper-level assignments move and count in the trace, in
    both packages, so the stop can come at another sweep."""
    from repro.solver import SolveConfig as JConfig
    from repro.solver.compiled import BatchedDenseSolver as JHandle

    sizes = [30, 41, 17]
    kw = dict(backend=order, levels=levels, stop=stop, max_iterations=60,
              preference=preference)
    cfg = SolveConfig(device="cpu", **kw)
    pts = np.zeros((4, 48, 2), np.float32)
    n_real = np.full(4, 2, np.int32)
    xs = []
    for i, m in enumerate(sizes):
        xs.append(gaussian_blobs(n=m, k=3, seed=10 + i, spread=0.5)[0])
        pts[i, :m], n_real[i] = xs[-1], m
    raw = compiled.BatchedDenseSolver(4, 48, 2, cfg).compile().run(pts,
                                                                   n_real)
    want = JHandle(4, 48, 2, JConfig(**kw)).compile().run(pts, n_real)
    real = slice(0, len(sizes))      # the filler slot's two points tie
    for field in ("exemplars", "n_sweeps", "converged", "trace",
                  "preferences"):
        np.testing.assert_array_equal(getattr(raw, field)[real],
                                      np.asarray(getattr(want, field))[real])
    if levels == 2 and stop == "converged":
        return
    for i, m in enumerate(sizes):
        rbr, pref = compiled.slice_request(raw, i, m, stop)
        alone = solve(xs[i], config=cfg)
        got = np.stack([e[e] for e in np.asarray(rbr.exemplars)])
        np.testing.assert_array_equal(got, alone.exemplars)
        assert rbr.n_sweeps == alone.n_sweeps
        assert rbr.converged == alone.converged
        if isinstance(preference, str):
            from repro_torch.core.preferences import make_preferences
            from repro_torch.core.similarity import pairwise_similarity
            s = pairwise_similarity(torch.from_numpy(xs[i]))
            assert pref == float(make_preferences(s, preference)[0])
        else:
            assert pref == preference
