"""Flat affinity propagation in the port (``repro_torch.core.affinity``,
``canonicalize``, ``net_similarity``) — the counterpart of
``tests/test_affinity.py``: its eight tests on the port. The hand-checked
messages also equal the reference's; flat AP's decisions are held to
C2's bar (ROADMAP): the properties the reference's tests check, and the
reference's exemplars where both runs have converged."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")  # dev-only dep: requirements-dev.txt
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import (  # noqa: E402
    affinity_propagation, canonicalize, net_similarity, pairwise_similarity,
    purity, set_preferences,
)
from repro_torch.core.affinity import (  # noqa: E402
    availability_update, masked_top2, responsibility_update,
)
from repro_torch.core.preferences import median_preference  # noqa: E402
from repro_torch.data import gaussian_blobs  # noqa: E402


def _sim(x):
    s = pairwise_similarity(torch.as_tensor(np.asarray(x, np.float32)))
    return set_preferences(s, median_preference(s))


def _ref_ap(x, **kw):
    import jax.numpy as jnp
    from repro.core import affinity_propagation as ap
    from repro.core import pairwise_similarity as ps, set_preferences as sp
    from repro.core.preferences import median_preference as mp
    s = ps(jnp.asarray(np.asarray(x, np.float32)))
    return ap(sp(s, mp(s)), **kw)


def test_masked_top2_matches_manual(rng):
    v = torch.as_tensor(rng.standard_normal((10, 17)).astype(np.float32))
    m1, i1, m2 = masked_top2(v)
    vn = v.numpy()
    np.testing.assert_allclose(m1.numpy(), vn.max(1), atol=1e-6)
    np.testing.assert_array_equal(i1.numpy(), vn.argmax(1))
    for r in range(10):
        row = vn[r].copy()
        row[row.argmax()] = -np.inf
        assert abs(float(m2[r]) - row.max()) < 1e-6


def test_responsibility_manual_small():
    import jax.numpy as jnp
    from repro.core.affinity import responsibility_update as ref_r
    s = [[0.0, -1.0, -4.0], [-1.0, 0.0, -2.0], [-4.0, -2.0, 0.0]]
    r = responsibility_update(torch.tensor(s), torch.zeros(3, 3)).numpy()
    # row 0: v = [0, -1, -4]; max=0 (j=0), second=-1
    np.testing.assert_allclose(r[0], [0 - (-1), -1 - 0, -4 - 0], atol=1e-6)
    np.testing.assert_array_equal(
        r, np.asarray(ref_r(jnp.asarray(s), jnp.zeros((3, 3)))))


def test_availability_manual_small():
    import jax.numpy as jnp
    from repro.core.affinity import availability_update as ref_a
    r = [[0.5, -1.0, 2.0], [1.0, -0.5, -3.0], [-2.0, 3.0, 0.25]]
    a = availability_update(torch.tensor(r)).numpy()
    # a(j,j) = sum_{k!=j} max(0, r(k,j))
    np.testing.assert_allclose(np.diag(a), [1.0, 3.0, 2.0], atol=1e-6)
    # a(0,1) = min(0, r(1,1) + sum_{k not in {0,1}} max(0, r(k,1)))
    assert abs(a[0, 1] - min(0.0, -0.5 + 3.0)) < 1e-6
    assert abs(a[1, 0] - min(0.0, 0.5 + 0.0)) < 1e-6
    np.testing.assert_array_equal(a, np.asarray(ref_a(jnp.asarray(r))))


def test_ap_clusters_blobs():
    x, y = gaussian_blobs(n=150, k=4, seed=1, spread=0.4)
    res = affinity_propagation(_sim(x), iterations=120, damping=0.7)
    labels = canonicalize(res.exemplars.numpy())
    assert purity(labels, y) > 0.95
    assert 3 <= int(res.n_clusters) <= 12
    ref = _ref_ap(x, iterations=120, damping=0.7)
    assert int(res.n_clusters) == int(ref.n_clusters)


def test_ap_exemplars_are_valid_indices():
    x, _ = gaussian_blobs(n=60, k=3, seed=2)
    e = affinity_propagation(_sim(x), iterations=60,
                             damping=0.6).exemplars.numpy()
    assert np.all((0 <= e) & (e < 60))


def test_net_similarity_better_than_random():
    x, _ = gaussian_blobs(n=80, k=4, seed=3)
    s = _sim(x)
    res = affinity_propagation(s, iterations=80, damping=0.7)
    rng = np.random.default_rng(0)
    rand_e = torch.as_tensor(rng.integers(0, 80, 80))
    assert float(net_similarity(s, res.exemplars)) > float(
        net_similarity(s, rand_e))


def test_canonicalize_idempotent():
    x, _ = gaussian_blobs(n=50, k=3, seed=4)
    res = affinity_propagation(_sim(x), iterations=60, damping=0.6)
    once = canonicalize(res.exemplars.numpy())
    np.testing.assert_array_equal(once, canonicalize(once))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 50))
def test_property_damping_keeps_finite(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((24, 2)).astype(np.float32)
    res = affinity_propagation(_sim(x), iterations=40, damping=0.9)
    assert torch.isfinite(res.r).all() and torch.isfinite(res.a).all()
