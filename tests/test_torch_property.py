"""Property tests on the port's invariants — the counterpart of
``tests/test_property.py``'s first four properties (its fifth,
``test_topk_compress_keeps_largest``, has its counterpart in
``tests/test_torch_train.py::test_topk_compress_equals_reference``).

Flat AP is held to C2's bar (ROADMAP): its decisions drift from the
reference's where a run has not converged, so the translation property
compares exemplars where both runs have settled (the same exemplars after
40 and 60 iterations), with translated similarities within 1e-4 of the
original's largest |S|. The examples are drawn deterministically
(``derandomize``), so a run cannot flip with hypothesis's seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")  # dev-only dep: requirements-dev.txt
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import (  # noqa: E402
    affinity_propagation, pad_similarity, pairwise_similarity, run_hap,
    set_preferences, stack_levels,
)
from repro_torch.core.preferences import median_preference  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

PROFILE = settings(max_examples=15, deadline=None, derandomize=True)


def _sim(x):
    s = pairwise_similarity(torch.as_tensor(x))
    return set_preferences(s, median_preference(s))


def _settled(s, its=(40, 60)):
    runs = [affinity_propagation(s, iterations=i, damping=0.6).exemplars
            for i in its]
    return runs[-1].numpy(), bool(torch.equal(runs[0], runs[-1]))


@PROFILE
@given(n=st.integers(6, 32), seed=st.integers(0, 30))
def test_ap_translation_invariance(n, seed):
    """AP depends on pairwise distances only: translating the data moves S
    by rounding alone, and settled runs pick the same exemplars."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    s1, s2 = _sim(x), _sim(x + np.float32(7.5))
    assert (s1 - s2).abs().max() <= 1e-4 * s1.abs().max()
    (e1, ok1), (e2, ok2) = _settled(s1), _settled(s2)
    if ok1 and ok2:
        np.testing.assert_array_equal(e1, e2)


@PROFILE
@given(n=st.integers(6, 24), pad_to=st.integers(2, 12),
       seed=st.integers(0, 20))
def test_pad_similarity_inert(n, pad_to, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    s3 = stack_levels(_sim(x), 2)
    res = run_hap(s3, iterations=20, damping=0.6, order="parallel")
    s3p, n0 = pad_similarity(s3, pad_to)
    resp = run_hap(s3p, iterations=20, damping=0.6, order="parallel")
    assert n0 == n
    np.testing.assert_array_equal(resp.exemplars[:, :n].numpy(),
                                  res.exemplars.numpy())


@PROFILE
@given(n=st.integers(4, 20), m=st.integers(4, 20), seed=st.integers(0, 30),
       lam=st.floats(0.0, 0.95))
def test_responsibility_row_shift_equivariance(n, m, seed, lam):
    """Adding a per-row constant c_i to ``a`` shifts the fresh
    responsibility by exactly -c_i (the row max absorbs it):
    r2 = r1 - (1-lam)*shift."""
    rng = np.random.default_rng(seed)
    s = torch.as_tensor(-rng.random((n, m)).astype(np.float32))
    a = torch.as_tensor(rng.standard_normal((n, m)).astype(np.float32))
    tau = torch.full((n,), float("inf"))
    r_old = torch.zeros((n, m))
    shift = torch.as_tensor(rng.standard_normal((n, 1)).astype(np.float32))
    r1 = ref.responsibility(s, a, tau, r_old, lam)
    r2 = ref.responsibility(s, a + shift, tau, r_old, lam)
    np.testing.assert_allclose(r2.numpy(),
                               r1.numpy() - (1 - lam) * shift.numpy(),
                               rtol=1e-3, atol=1e-3)


@PROFILE
@given(n=st.integers(4, 16), seed=st.integers(0, 20))
def test_exemplars_stable_under_duplicate_points(n, seed):
    """Duplicating a point must not break finiteness or index validity."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    x2 = np.concatenate([x, x[:1]])
    res = affinity_propagation(_sim(x2), iterations=30, damping=0.7)
    e = res.exemplars.numpy()
    assert np.all((0 <= e) & (e <= n))
    assert torch.isfinite(res.r).all()
