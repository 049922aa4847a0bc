"""The port's streaming module and ``sharded_streaming`` backend on the CPU
against the JAX reference (``tests/test_streaming.py`` is the oracle).

Both packages cut the same shards (the same numpy permutation). Given the
reference's similarities (patched into the port's module), every decision
must be equal: each point's shard exemplar and final exemplar, the labels
and the cluster count. From points each package builds its own S: XLA
contracts the row norms into FMAs and PyTorch rounds every operation
(``ROADMAP.md`` C2), which moves S by up to 6.1e-5 here. A shard's AP run
of 60 sweeps that has not settled can then pick other shard exemplars: in
the first case 42 of 1,200 points (3.5 %) take another shard exemplar, so
the shard exemplars may differ on at most ``MAX_SHARD_FLIP`` of the
points; the final exemplars, labels and counts must still be equal.
``assign_nearest_exemplar`` sums its dot products in a fixed order, so any
row or column chunking gives the same bits; against the reference's matmul
the labels are equal and each ``best_sim`` agrees within
``similarity.tolerance`` of its pair (two roundings of ``xx + yy - 2 x.e``,
a few ulps of ``xx + yy``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import streaming as j_streaming  # noqa: E402
from repro.core.preferences import median_preference as j_median  # noqa: E402
from repro.core.similarity import (  # noqa: E402
    pairwise_similarity as j_pairwise, set_preferences as j_set_prefs,
)
from repro.data import gaussian_blobs  # noqa: E402
from repro.solver import solve as j_solve  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.core.assignments import canonicalize  # noqa: E402
from repro_torch.core.metrics import purity  # noqa: E402
from repro_torch.kernels import similarity  # noqa: E402
from repro_torch.solver import solve  # noqa: E402

MAX_SHARD_FLIP = 0.05   # share of points whose shard exemplar may move (C2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run thousands of small PyTorch ops; beside the suite's
    other parallel workers, intra-op threads oversubscribe the cores and
    slow each op tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_streaming(got, want, shard_flip=0.0):
    assert (got.shard_exemplars != want.shard_exemplars).mean() <= shard_flip
    np.testing.assert_array_equal(got.exemplar_of, want.exemplar_of)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.n_clusters == want.n_clusters
    np.testing.assert_array_equal(got.exemplar_points, want.exemplar_points)


# ------------------------------------------------------------ streaming
CASES = [  # n, k, seed, spread, box, shard, iterations, pref_scale
    (1200, 6, 4, 0.4, 16.0, 256, 60, 0.25),      # quality case
    (2000, 5, 5, 0.6, 10.0, 200, 40, 1.0),       # shard-local state case
    (240, 3, 9, 0.5, 4.0, 60, 60, 50.0),         # one global exemplar
    (500, 5, 10, 0.4, 16.0, 128, 60, 0.25),      # second-pass invariant
    (301, 4, 2, 0.5, 10.0, 100, 30, 1.0),        # a one-point last shard
]


@pytest.mark.parametrize("n,k,seed,spread,box,shard,iters,scale,shared_s", [
    (*case, shared) for case in CASES for shared in (True, False)
    # the reference's S, patched in, costs an XLA build a shard shape:
    # held on the case where C2 moves shard exemplars and two small ones
    if not shared or case[0] in (1200, 240, 301)])
def test_streaming_matches_reference(n, k, seed, spread, box, shard, iters,
                                     scale, shared_s, monkeypatch):
    x, _ = gaussian_blobs(n=n, k=k, seed=seed, spread=spread, box=box)
    if shared_s:
        monkeypatch.setattr(streaming, "pairwise_similarity", lambda t: (
            torch.from_numpy(np.asarray(j_pairwise(jnp.asarray(t.numpy()))))))
    got = streaming.streaming_hap(x, shard_size=shard, iterations=iters,
                                  pref_scale=scale)
    want = j_streaming.streaming_hap(x, shard_size=shard, iterations=iters,
                                     pref_scale=scale)
    _same_streaming(got, want, 0.0 if shared_s else MAX_SHARD_FLIP)


def test_streaming_quality_and_compression():
    x, y = gaussian_blobs(n=1200, k=6, seed=4, spread=0.4, box=16.0)
    res = streaming.streaming_hap(x, shard_size=256, iterations=60,
                                  pref_scale=0.25)
    assert res.labels.shape == (1200,)
    assert purity(res.labels, y) > 0.8
    assert res.n_clusters < len(np.unique(res.shard_exemplars))
    assert res.labels.max() + 1 == res.n_clusters


def test_streaming_single_global_exemplar_reassigns_whole_shards():
    x, _ = gaussian_blobs(n=240, k=3, seed=9, spread=0.5, box=4.0)
    res = streaming.streaming_hap(x, shard_size=60, iterations=60,
                                  pref_scale=50.0)
    assert res.n_clusters == 1 and np.all(res.labels == 0)
    global_ex = int(np.unique(res.exemplar_of)[0])
    losers = [e for e in np.unique(res.shard_exemplars) if e != global_ex]
    assert losers
    for e in losers:
        members = np.flatnonzero(res.shard_exemplars == e)
        assert np.all(res.exemplar_of[members] == global_ex)


def test_streaming_labels_are_nearest_exemplar_and_reads_are_counted():
    x, _ = gaussian_blobs(n=500, k=5, seed=10, spread=0.4, box=16.0)
    obs.reset_counters("host_copies.streaming")
    res = streaming.streaming_hap(x, shard_size=128, iterations=60,
                                  pref_scale=0.25)
    # one read per shard, one for the exemplar tier, one for the labels
    assert obs.counters()["host_copies.streaming"] == 4 + 1 + 1
    labels, _ = streaming.assign_nearest_exemplar(x, res.exemplar_points)
    np.testing.assert_array_equal(labels.numpy(), res.labels)


# ------------------------------------------------------------ assignment
def test_assign_matches_reference_and_chunking_is_bit_identical():
    x, _ = gaussian_blobs(n=777, k=6, seed=11, spread=0.4, box=16.0)
    ex = x[np.random.default_rng(0).choice(777, 61, replace=False)]
    ref_l, ref_b = streaming.assign_nearest_exemplar(x, ex, chunk=777)
    want_l, want_b = j_streaming.assign_nearest_exemplar(x, ex, chunk=777)
    np.testing.assert_array_equal(ref_l.numpy(), want_l)
    tol = similarity.tolerance(torch.from_numpy(x), torch.from_numpy(ex))
    tol = tol.gather(1, ref_l.long()[:, None])[:, 0].numpy()
    assert (np.abs(ref_b.numpy() - want_b) <= tol).all()
    for chunk, col_chunk in [(64, None), (777, 7), (100, 13), (16, 4),
                             (5, 3)]:
        lab, best = streaming.assign_nearest_exemplar(x, ex, chunk=chunk,
                                                      col_chunk=col_chunk)
        assert torch.equal(lab, ref_l) and torch.equal(best, ref_b)
    # 1-wide blocks (a matmul would take another kernel there), on a prefix
    lab, best = streaming.assign_nearest_exemplar(x[:100], ex, chunk=1,
                                                  col_chunk=1)
    assert torch.equal(lab, ref_l[:100]) and torch.equal(best, ref_b[:100])


def test_assign_single_exemplar_and_its_own_distance():
    x, _ = gaussian_blobs(n=200, k=5, seed=8, box=12.0)
    ex = x[17:18]
    labels, best = streaming.assign_nearest_exemplar(x, ex)
    assert labels.dtype == torch.int32 and bool((labels == 0).all())
    np.testing.assert_allclose(best.numpy(), -((x - ex[0]) ** 2).sum(1),
                               rtol=1e-4, atol=1e-3)
    assert float(best[17]) == 0.0


def test_assign_column_chunk_ties_resolve_to_first():
    x = np.zeros((5, 3), np.float32)
    ex = np.zeros((4, 3), np.float32)          # all ties at distance 0
    for col_chunk in (None, 1, 2, 3):
        lab, best = streaming.assign_nearest_exemplar(x, ex,
                                                      col_chunk=col_chunk)
        assert bool((lab == 0).all()) and bool((best == 0.0).all())


# ---------------------------------------------------------- converged AP
def _ref_stack(x):
    s = j_pairwise(jnp.asarray(x))
    return j_set_prefs(s, j_median(s))


@pytest.mark.parametrize("n,k,seed,max_it,patience", [
    (150, 4, 6, 400, 20), (60, 3, 7, 5, 100), (96, 4, 3, 200, 10)])
def test_converged_ap_matches_reference(n, k, seed, max_it, patience):
    """From the reference's S: the exemplars, the sweep count and the flag
    are equal, and the loop reads the host once per sweep."""
    x, _ = gaussian_blobs(n=n, k=k, seed=seed, spread=0.4)
    s = _ref_stack(x)
    want = j_streaming.converged_ap(s, max_iterations=max_it,
                                    patience=patience, damping=0.7)
    obs.reset_counters("host_copies.streaming")
    got = streaming.converged_ap(torch.from_numpy(np.asarray(s)),
                                 max_iterations=max_it, patience=patience,
                                 damping=0.7)
    np.testing.assert_array_equal(got.exemplars.numpy(),
                                  np.asarray(want.exemplars))
    assert got.n_iterations == int(want.n_iterations)
    assert got.converged == bool(want.converged)
    assert obs.counters()["host_copies.streaming"] == got.n_iterations


def test_converged_ap_stops_early_with_good_clusters():
    x, y = gaussian_blobs(n=150, k=4, seed=6, spread=0.4)
    res = streaming.converged_ap(torch.from_numpy(np.asarray(_ref_stack(x))),
                                 max_iterations=400, patience=20)
    assert res.converged and res.n_iterations < 400
    assert purity(canonicalize(res.exemplars.numpy()), y) > 0.9


# ------------------------------------------------------------- backend
def test_backend_matches_reference_solve():
    x, _ = gaussian_blobs(n=900, k=5, seed=3, spread=0.5)
    kw = dict(backend="sharded_streaming", levels=1, shard_size=200,
              max_iterations=40)
    got = solve(x, device="cpu", **kw)
    want = j_solve(x, **kw)
    assert got.backend == want.backend == "sharded_streaming"
    np.testing.assert_array_equal(got.exemplars, want.exemplars)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.n_clusters, want.n_clusters)
    assert got.n_sweeps == want.n_sweeps == 40
    assert got.converged is None and got.trace.shape == (0,)


def test_backend_needs_points_and_a_fixed_budget():
    x, _ = gaussian_blobs(n=64, k=3, seed=5)
    s = np.asarray(j_pairwise(jnp.asarray(x)))
    with pytest.raises(ValueError, match="raw points"):
        solve(s, backend="sharded_streaming", device="cpu")
    with pytest.raises(ValueError, match="does not support stop='converged'"):
        solve(x, backend="sharded_streaming", stop="converged", device="cpu")


def test_default_one_level_solve_routes_big_point_sets_to_streaming():
    """C1, first half: ``solve(x, levels=1)`` with N >= 8,192 points runs
    ``sharded_streaming`` (it raised KeyError before the backend was
    registered)."""
    x, _ = gaussian_blobs(n=8192, k=8, seed=0, spread=0.5)
    res = solve(x, levels=1, device="cpu", max_iterations=3)
    assert res.backend == "sharded_streaming"
    assert res.exemplars.shape == (1, 8192) and res.n_sweeps == 3
    e = res.exemplars[0]
    np.testing.assert_array_equal(e[e], e)
