"""The port's comparison baselines (``repro_torch.baselines``) on the CPU:
the four tests of ``tests/test_baselines.py`` on the port, and parity with
the JAX reference.

* ``kmeans`` from the same ``init_centers``: labels equal, centers and
  inertia within 1e-5 relative (the two packages' matmuls sum in other
  orders). The default initial centers differ by design: the reference
  draws them with ``jax.random.choice``, the port with ``torch.randperm``
  from ``seed`` (``ROADMAP.md`` C3).
* ``canopy_centers`` and ``auto_thresholds``: host numpy in both, so bit
  for bit.
* ``hierarchical_kmeans``: the top level is K-means from the canopy seeds
  in both packages, so it equals the reference's; the lower levels seed
  each sub-K-means from the same numpy stream but with the port's own draw
  (C3), so they are held to the hierarchy's contract (levels nest, purity).
* ``kmeans_distributed`` on a 4-rank gloo group: every rank's labels equal
  the one-process ``kmeans``; centers and inertia within 1e-5 relative.

JAX is imported inside the tests: the ranks import this module.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.baselines import (  # noqa: E402
    canopy_centers, hierarchical_kmeans, kmeans,
)
from repro_torch.baselines.canopy import auto_thresholds  # noqa: E402
from repro_torch.core.metrics import purity  # noqa: E402
from repro_torch.data import aggregation_like, gaussian_blobs  # noqa: E402
from repro_torch.sharding import dist  # noqa: E402

RTOL = 1e-5
WORLD = 4


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1.0)


# ------------------------------------------- tests/test_baselines.py's four
def test_kmeans_blobs():
    x, y = gaussian_blobs(n=200, k=4, seed=0, spread=0.3)
    res = kmeans(x, 4, iterations=30, seed=7, device="cpu")
    assert purity(res.labels.numpy(), y) > 0.9  # random init sensitivity


def test_kmeans_inertia_decreases_with_k():
    x, _ = gaussian_blobs(n=150, k=5, seed=1)
    i2 = float(kmeans(x, 2, iterations=20, device="cpu").inertia)
    i8 = float(kmeans(x, 8, iterations=20, device="cpu").inertia)
    assert i8 < i2


def test_canopy_discovers_reasonable_centers():
    x, _ = gaussian_blobs(n=300, k=5, seed=2, spread=0.3, box=20.0)
    t1, t2 = auto_thresholds(x)
    centers = canopy_centers(x, t1, t2)
    assert 2 <= len(centers) <= 60


def test_hkmeans_hierarchy_shape():
    x, y = aggregation_like()
    hk = hierarchical_kmeans(x, levels=3, branch=3, device="cpu")
    assert hk.labels.shape == (3, len(x))
    # finer levels have at least as many clusters
    assert hk.n_clusters[0] >= hk.n_clusters[1] >= hk.n_clusters[2]
    assert purity(hk.labels[0], y) > 0.9
    # the levels nest: a finer cluster never straddles two coarser ones
    for fine, coarse in zip(hk.labels[:-1], hk.labels[1:]):
        for c in np.unique(fine):
            assert len(np.unique(coarse[fine == c])) == 1


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("n,k,seed", [(200, 4, 0), (333, 7, 1), (600, 6, 2)])
def test_kmeans_equals_the_reference_from_the_same_centers(n, k, seed):
    import jax.numpy as jnp
    from repro.baselines import kmeans as j_kmeans

    x, _ = gaussian_blobs(n=n, k=k, seed=seed, spread=0.5)
    init = x[np.random.default_rng(seed).choice(n, k, replace=False)]
    want = j_kmeans(jnp.asarray(x), k, iterations=25,
                    init_centers=jnp.asarray(init))
    got = kmeans(x, k, iterations=25, init_centers=init, device="cpu")
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.labels.dtype == torch.int32
    _close(got.centers.numpy(), want.centers)
    _close(float(got.inertia), float(want.inertia))


def test_kmeans_default_init_is_seeded():
    """The default centers are k distinct points drawn from ``seed``: the
    same on every call, other for another seed (C3: not the reference's
    draw)."""
    x, _ = gaussian_blobs(n=150, k=5, seed=1)
    a, b = (kmeans(x, 5, iterations=0, seed=3, device="cpu")
            for _ in range(2))
    torch.testing.assert_close(a.centers, b.centers, rtol=0, atol=0)
    assert len({tuple(c) for c in a.centers.numpy()}) == 5
    c = kmeans(x, 5, iterations=0, seed=4, device="cpu")
    assert not torch.equal(a.centers, c.centers)


def test_numpy_input_asks_for_a_device():
    """Numpy input runs on ``device``, CUDA by default: without a card that
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    x, _ = gaussian_blobs(n=40, k=2, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kmeans(x, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hierarchical_kmeans(x)
    # a tensor runs where it is
    assert kmeans(torch.from_numpy(x), 2).labels.device.type == "cpu"


@pytest.mark.parametrize("maker", [
    lambda: gaussian_blobs(n=300, k=5, seed=2, spread=0.3, box=20.0),
    lambda: aggregation_like(),
    lambda: gaussian_blobs(n=2000, k=16, seed=0, spread=0.5),
], ids=["blobs300", "aggregation", "blobs2000"])
def test_canopy_is_bit_equal(maker):
    from repro.baselines import canopy_centers as j_canopy
    from repro.baselines.canopy import auto_thresholds as j_thresholds

    x, _ = maker()
    for seed in (0, 5):
        t = auto_thresholds(x, seed)
        assert t == j_thresholds(x, seed)
        got = canopy_centers(x, *t, seed)
        want = j_canopy(x, *t, seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("maker", [
    lambda: aggregation_like(),
    lambda: gaussian_blobs(n=600, k=6, seed=2, spread=0.5),
], ids=["aggregation", "blobs600"])
def test_hkmeans_top_level_equals_the_reference(maker):
    """The top level is K-means from the canopy seeds in both packages."""
    import jax.numpy as jnp
    from repro.baselines import kmeans as j_kmeans

    x, y = maker()
    hk = hierarchical_kmeans(x, levels=3, branch=3, device="cpu")
    t1, t2 = auto_thresholds(x, 0)
    seeds = canopy_centers(x, t1, t2, 0)
    want = j_kmeans(jnp.asarray(x), max(2, len(seeds)), iterations=25,
                    init_centers=jnp.asarray(seeds))
    np.testing.assert_array_equal(hk.labels[-1], np.asarray(want.labels))
    assert hk.n_clusters[-1] == len(np.unique(np.asarray(want.labels)))
    assert purity(hk.labels[0], y) > 0.9


# ------------------------------------------------------- MapReduce K-means
N_DIST, K_DIST = 400, 5


def _dist_points():
    x, _ = gaussian_blobs(n=N_DIST, k=K_DIST, seed=3, spread=0.5)
    return x, x[np.random.default_rng(3).choice(N_DIST, K_DIST,
                                                replace=False)]


def _ranks(x, init):
    from repro_torch.baselines import kmeans_distributed
    from repro_torch.launch.mesh import make_worker_mesh

    mesh = make_worker_mesh()
    res = kmeans_distributed(x, K_DIST, mesh, iterations=25,
                             init_centers=init, device="cpu")
    try:
        kmeans_distributed(x[:-1], K_DIST, mesh, device="cpu")
        refused = None
    except ValueError as err:
        refused = str(err)
    sent = mesh.traffic.bytes_sent
    return (res.labels.numpy(), res.centers.numpy(), float(res.inertia),
            refused, sent)


@pytest.fixture(scope="module")
def dist_points():
    return _dist_points()


@pytest.fixture(scope="module")
def ranks(dist_points):
    return dist.spawn(_ranks, WORLD, args=dist_points)


def test_kmeans_distributed_equals_one_process(ranks, dist_points):
    x, init = dist_points
    ref = kmeans(x, K_DIST, iterations=25, init_centers=init, device="cpu")
    for labels, centers, inertia, _, sent in ranks:
        np.testing.assert_array_equal(labels, ref.labels.numpy())
        _close(centers, ref.centers.numpy())
        _close(inertia, float(ref.inertia))
        # 25 steps of (sums, counts), the inertia and the labels' gather
        assert sent > 0
    # every rank holds the same centers bit for bit (rank-order psum)
    for _, centers, inertia, _, _ in ranks[1:]:
        np.testing.assert_array_equal(centers, ranks[0][1])
        assert inertia == ranks[0][2]


def test_kmeans_distributed_equals_the_reference(ranks, dist_points):
    import jax.numpy as jnp
    from repro.baselines import kmeans as j_kmeans

    x, init = dist_points
    want = j_kmeans(jnp.asarray(x), K_DIST, iterations=25,
                    init_centers=jnp.asarray(init))
    np.testing.assert_array_equal(ranks[0][0], np.asarray(want.labels))
    _close(ranks[0][1], want.centers)


def test_kmeans_distributed_refuses_a_ragged_split(ranks):
    for out in ranks:
        assert out[3] == f"N={N_DIST - 1} must divide workers={WORLD}"
