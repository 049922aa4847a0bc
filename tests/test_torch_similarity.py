"""The port's similarity builders and preferences
(``repro_torch.core.similarity``, ``repro_torch.core.preferences``) on the
CPU: the nine tests of ``tests/test_similarity.py`` on the port, and parity
with the JAX reference, the blockwise builder at a ragged N (N not a
multiple of ``block``) included.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import similarity as ref  # noqa: E402
from repro_torch.core import pairwise_similarity_blockwise  # noqa: E402
from repro_torch.core.preferences import (  # noqa: E402
    make_preferences, median_preference, range_mid_preference,
)
from repro_torch.core.similarity import (  # noqa: E402
    pairwise_similarity, set_preferences, stack_levels,
)

# the two packages' S from the same points: ||x||^2 + ||y||^2 - 2<x, y> in
# float32 with another summation order (ROADMAP C2)
ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_neg_sqeuclidean_matches_numpy(rng):
    x = rng.standard_normal((40, 5)).astype(np.float32)
    s = pairwise_similarity(_t(x)).numpy()
    want = -((x[:, None] - x[None]) ** 2).sum(-1)
    np.testing.assert_allclose(s, want, atol=ATOL)


def test_blockwise_matches_dense(rng):
    x = rng.standard_normal((100, 3)).astype(np.float32)
    dense = pairwise_similarity(_t(x))
    block = pairwise_similarity_blockwise(_t(x), block=32)
    np.testing.assert_allclose(dense.numpy(), block.numpy(), atol=ATOL)


@pytest.mark.parametrize("metric", ["neg_sqeuclidean", "neg_euclidean",
                                    "cosine"])
@pytest.mark.parametrize("n,block", [(100, 32), (130, 512), (7, 3)])
def test_blockwise_matches_the_reference(metric, n, block):
    """Ragged N: the last tile is zero-padded and its padded rows dropped,
    as the reference's ``lax.map`` over tiles does. neg_euclidean is the
    square root of a squared distance that carries the drift above, which
    the root magnifies near 0 (the diagonal): it is held on its square."""
    x = np.random.default_rng(n).standard_normal((n, 4)).astype(np.float32)
    got = pairwise_similarity_blockwise(_t(x), metric, block).numpy()
    want = np.asarray(ref.pairwise_similarity_blockwise(
        jnp.asarray(x), metric, block))
    assert got.shape == (n, n)
    if metric == "neg_euclidean":
        got, want = got * got, want * want
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_similarity_nonpositive_offdiag(rng):
    x = rng.standard_normal((30, 4)).astype(np.float32)
    s = pairwise_similarity(_t(x)).numpy()
    assert np.all(s[~np.eye(30, dtype=bool)] <= 1e-6)


def test_set_preferences_diagonal(rng):
    x = rng.standard_normal((20, 2)).astype(np.float32)
    s = pairwise_similarity(_t(x))
    pref = torch.arange(20, dtype=torch.float32) * -1.0
    s2 = set_preferences(s, pref).numpy()
    np.testing.assert_allclose(np.diag(s2), pref.numpy())
    off = ~np.eye(20, dtype=bool)
    np.testing.assert_allclose(s2[off], s.numpy()[off])


def test_stack_levels():
    assert stack_levels(torch.ones(5, 5), 4).shape == (4, 5, 5)


def test_median_preference_is_median(rng):
    x = rng.standard_normal((15, 3)).astype(np.float32)
    s = pairwise_similarity(_t(x))
    off = s.numpy()[~np.eye(15, dtype=bool)]
    assert abs(float(median_preference(s)[0]) - np.median(off)) < 1e-4


def test_range_mid_preference(rng):
    x = rng.standard_normal((12, 3)).astype(np.float32)
    s = pairwise_similarity(_t(x))
    off = s.numpy()[~np.eye(12, dtype=bool)]
    mid = float(range_mid_preference(s)[0])
    assert abs(mid - 0.5 * (off.min() + off.max())) < 1e-3


def test_random_preferences_in_range():
    """Drawn from the port's generator (ROADMAP C3), in the asked range."""
    g = torch.Generator().manual_seed(0)
    p = make_preferences(torch.zeros(10, 10), "random", generator=g,
                         low=-100.0, high=-1.0)
    assert p.shape == (10,)
    assert bool(((p >= -100.0) & (p <= -1.0)).all())


@settings(max_examples=20, deadline=None)
@given(n=st.integers(3, 24), d=st.integers(1, 6), seed=st.integers(0, 99))
def test_property_similarity_symmetric_offdiag(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    s = pairwise_similarity(_t(x)).numpy()
    np.testing.assert_allclose(s, s.T, atol=1e-3)
    assert np.all(np.diag(s) >= -1e-4)
    want = np.asarray(ref.pairwise_similarity(jnp.asarray(x)))
    np.testing.assert_allclose(s, want, atol=ATOL, rtol=1e-5)
