"""The port's clustering metrics (``repro_torch.core.metrics``) — the
counterpart of ``tests/test_metrics.py``: its six tests on the port, each
value also equal to the reference's."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")  # dev-only dep: requirements-dev.txt
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import metrics as ref  # noqa: E402
from repro_torch.core.metrics import cluster_sizes, nmi, purity  # noqa: E402


def test_purity_perfect():
    assert purity([0, 0, 1, 1], [1, 1, 0, 0]) == 1.0


def test_purity_known_value():
    labels = [0, 0, 0, 1, 1, 1]
    truth = [0, 0, 1, 1, 1, 0]
    assert abs(purity(labels, truth) - 4 / 6) < 1e-9
    assert purity(labels, truth) == ref.purity(labels, truth)


def test_purity_singletons_is_one():
    assert purity(np.arange(10), np.zeros(10, int)) == 1.0


def test_nmi_perfect_and_independent():
    assert abs(nmi([0, 0, 1, 1], [1, 1, 0, 0]) - 1.0) < 1e-9
    v = nmi([0, 1, 0, 1], [0, 0, 1, 1])
    assert v < 1e-9
    assert v == ref.nmi([0, 1, 0, 1], [0, 0, 1, 1])


def test_cluster_sizes():
    np.testing.assert_array_equal(cluster_sizes([0, 0, 2, 2, 2]), [2, 3])


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 4), min_size=2, max_size=40),
       st.integers(0, 99))
def test_property_purity_bounds_and_permutation_invariance(truth, seed):
    truth = np.asarray(truth)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, truth.size)
    p = purity(labels, truth)
    assert 0.0 < p <= 1.0
    # relabeling clusters does not change purity
    perm = rng.permutation(3)
    assert abs(purity(perm[labels], truth) - p) < 1e-12
    assert p == ref.purity(labels, truth)
    assert nmi(labels, truth) == pytest.approx(ref.nmi(labels, truth),
                                               abs=1e-12)
    np.testing.assert_array_equal(cluster_sizes(labels),
                                  ref.cluster_sizes(labels))
