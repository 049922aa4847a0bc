"""The port's HAP core against the JAX reference, on the CPU.

Single-sweep parity: the reference runs 5 sweeps, ``repro_torch.convert``
carries its state across, and one more sweep runs on each side from the
same state. Tolerance: ``rtol=1e-5`` and ``atol=1e-5 * max|s|`` — XLA
contracts multiply-adds into FMAs, PyTorch rounds each op, so one sweep
differs by a few ulps of the largest message. The sweep's assignments
(argmax of a + r) must match exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import affinity as j_aff  # noqa: E402
from repro.core import hap as j_hap  # noqa: E402
from repro.core import preferences as j_pref  # noqa: E402
from repro.core.similarity import (  # noqa: E402
    pairwise_similarity as j_pairwise,
)
from repro.data import gaussian_blobs  # noqa: E402
from repro.solver import dense as j_dense  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    hap_state_from_numpy, hap_state_to_numpy,
)
from repro_torch.core import affinity, hap, preferences  # noqa: E402
from repro_torch.core.similarity import (  # noqa: E402
    pairwise_similarity, set_preferences, stack_levels,
)
from repro_torch.solver import dense  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def blobs_s3():
    """Reference (L=3, N=80) stack with the median preference, as numpy."""
    x, _ = gaussian_blobs(n=80, k=4, seed=3, spread=0.5)
    s = j_pairwise(jnp.asarray(x))
    s = s.at[jnp.arange(80), jnp.arange(80)].set(j_pref.median_preference(s))
    return np.asarray(j_hap.hap_init(jnp.stack([s] * 3)).s)


@pytest.fixture(scope="module")
def after_five(blobs_s3):
    """Reference state after 5 Jacobi sweeps, per s_mode."""
    out = {}
    for mode in ("off", "paper", "evidence"):
        st = j_hap.hap_init(jnp.asarray(blobs_s3))
        for it in range(5):
            st = j_hap.hap_sweep_parallel(st, 0.7, 0.1, mode, it == 0)
        out[mode] = st
    return out


@pytest.mark.parametrize("n", [2, 3, 5, 8, 11])
def test_median_and_range_mid_match_reference(n, rng):
    """Duplicate-heavy matrices; N*N - N off-diagonal entries is always
    even, so the median is the mean of the two middle order statistics."""
    s = -rng.integers(0, 5, (n, n)).astype(np.float32)
    s[np.arange(n), np.arange(n)] = 100.0      # diagonal must not count
    for mine, ref in ((preferences.median_preference,
                       j_pref.median_preference),
                      (preferences.range_mid_preference,
                       j_pref.range_mid_preference)):
        np.testing.assert_array_equal(mine(_t(s)).numpy(),
                                      np.asarray(ref(jnp.asarray(s))))
    # values where the two middle order statistics differ
    s = np.arange(n * n, dtype=np.float32).reshape(n, n)
    want = np.median(s[~np.eye(n, dtype=bool)])
    np.testing.assert_array_equal(
        preferences.median_preference(_t(s)).numpy(), np.full(n, want))


def test_random_preference_is_seeded_and_in_range():
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    p1 = preferences.make_preferences(torch.zeros(6, 6), "random",
                                      generator=g1)
    p2 = preferences.make_preferences(torch.zeros(6, 6), "random",
                                      generator=g2)
    assert torch.equal(p1, p2)
    assert bool(((p1 >= -1e6) & (p1 <= 0)).all())
    with pytest.raises(ValueError, match="Generator"):
        preferences.make_preferences(torch.zeros(6, 6), "random")


def test_argmax_takes_first_occurrence():
    v = torch.tensor([[1.0, 5.0, 5.0, 2.0], [3.0, 3.0, 3.0, 3.0],
                      [0.0, -1.0, 0.0, 0.0]])
    assert torch.argmax(v, dim=1).tolist() == [1, 0, 0]


@pytest.mark.parametrize("ties", [False, True])
def test_masked_top2_matches_reference(ties, rng):
    v = (rng.integers(-2, 3, (16, 33)) if ties
         else rng.standard_normal((16, 33))).astype(np.float32)
    want = j_aff.masked_top2(jnp.asarray(v))
    got = affinity.masked_top2(_t(v))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stack_levels_is_materialised():
    s3 = stack_levels(torch.zeros(4, 4), 3)
    s3[0, 0, 0] = 1.0
    assert float(s3[1:, 0, 0].abs().sum()) == 0.0


def test_similarity_and_preferences_match_reference(rng):
    x = rng.standard_normal((50, 5)).astype(np.float32)
    norms2 = 2 * float((x * x).sum(1).max())
    # neg_euclidean takes a square root: an ulp-level error d in a squared
    # distance near 0 (the diagonal) becomes sqrt(d) there.
    atols = {"neg_sqeuclidean": 1e-5 * norms2,
             "neg_euclidean": float(np.sqrt(8 * 2.0**-24 * norms2)),
             "cosine": 1e-5}
    for metric, atol in atols.items():
        want = np.asarray(j_pairwise(jnp.asarray(x), metric=metric))
        got = pairwise_similarity(_t(x), metric).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                                   err_msg=metric)
    s = pairwise_similarity(_t(x))
    p = _t(rng.standard_normal(50).astype(np.float32))
    out = set_preferences(s, p)
    np.testing.assert_array_equal(out.diagonal().numpy(), p.numpy())
    assert not torch.equal(out, s)          # a copy; s keeps its diagonal


def test_convert_round_trip(after_five):
    arrays = [np.asarray(a) for a in after_five["off"]]
    st = hap_state_from_numpy(arrays)
    assert isinstance(st, hap.HAPState)
    for a, b in zip(arrays, hap_state_to_numpy(st)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="expected 6"):
        hap_state_from_numpy(arrays[:5])


def _assert_same_state(mine: hap.HAPState, ref, scale):
    for name, g, w in zip(hap.HAPState._fields, hap_state_to_numpy(mine),
                          ref):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
    np.testing.assert_array_equal(
        hap.assignments(mine).numpy(),
        np.asarray(jnp.argmax(ref.a + ref.r, axis=2)))


@pytest.mark.parametrize("mode", ["off", "paper", "evidence"])
@pytest.mark.parametrize("order", ["sequential", "parallel", "fused"])
def test_single_sweep_parity_from_carried_state(order, mode, after_five):
    jst = after_five[mode]
    st = hap_state_from_numpy([np.asarray(a) for a in jst])
    if order == "sequential":
        want = j_hap.hap_sweep_sequential(jst, 0.7, 0.1, mode)
        got = hap.hap_sweep_sequential(st, 0.7, 0.1, mode)
    elif order == "parallel":
        want = j_hap.hap_sweep_parallel(jst, 0.7, 0.1, mode, False)
        got = hap.hap_sweep_parallel(st, 0.7, 0.1, mode, False)
    else:
        want = j_dense.fused_sweep(jst, False, lam=0.7, kappa=0.1,
                                   s_mode=mode, block=32)
        got = dense.fused_sweep(st, False, lam=0.7, kappa=0.1, s_mode=mode)
    _assert_same_state(got, want, float(np.abs(np.asarray(jst.s)).max()))


def test_first_sweep_keeps_tau_and_c(blobs_s3):
    st = hap.hap_sweep_parallel(hap.hap_init(_t(blobs_s3)), 0.7, 0.0, "off",
                                True)
    assert bool(torch.isinf(st.tau).all()) and not bool(st.c.any())
    want = j_hap.hap_sweep_parallel(j_hap.hap_init(jnp.asarray(blobs_s3)),
                                    0.7, 0.0, "off", True)
    _assert_same_state(st, want, float(np.abs(blobs_s3).max()))


@pytest.mark.parametrize("order", ["sequential", "parallel"])
def test_run_hap_matches_reference(order, blobs_s3):
    want = j_hap.run_hap(jnp.asarray(blobs_s3), iterations=20, damping=0.6,
                         order=order)
    got = hap.run_hap(_t(blobs_s3), iterations=20, damping=0.6, order=order)
    np.testing.assert_array_equal(got.exemplars.numpy(),
                                  np.asarray(want.exemplars))
    np.testing.assert_array_equal(got.n_clusters.numpy(),
                                  np.asarray(want.n_clusters))


def test_hap_init_conventions(blobs_s3):
    st = hap.hap_init(_t(blobs_s3))
    assert bool(torch.isinf(st.tau).all())
    assert not bool(st.phi.any()) and not bool(st.c.any())
    assert not bool(st.r.any()) and not bool(st.a.any())
