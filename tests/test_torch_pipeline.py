"""The port's data pipeline and expert-affinity hooks
(``repro_torch.data.pipeline``, ``repro_torch.core.expert_affinity``) on
the CPU: the four tests of ``tests/test_pipeline.py`` on the port, and
parity with the JAX reference — the token stream bit-equal (the same numpy
calls), the curated indices and the expert clusters equal.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.expert_affinity import (  # noqa: E402
    cluster_experts, expert_signatures,
)
from repro_torch.data.pipeline import (  # noqa: E402
    Prefetcher, hap_curate_batch, synthetic_token_stream,
)


def _near_copies(n_base, copies, d, seed=0, scale=4.0, noise=0.02):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n_base, d)).astype(np.float32) * scale
    return (np.repeat(base, copies, axis=0)
            + noise * rng.standard_normal((n_base * copies, d)))


def _router_probs(t=512, e=8, seed=1):
    """Experts 2j and 2j + 1 co-activate: identical routing signatures."""
    rng = np.random.default_rng(seed)
    probs = rng.random((t, e)).astype(np.float32) * 0.05
    hot = rng.integers(0, e // 2, t)
    for i, h in enumerate(hot):
        probs[i, 2 * h] += 0.5
        probs[i, 2 * h + 1] += 0.5
    probs /= probs.sum(1, keepdims=True)
    return probs


def _router_probs_reference():
    """``tests/test_pipeline.py``'s router probabilities (copied): pairs
    (0, 1) and (2, 3) co-activate, 8 experts."""
    rng = np.random.default_rng(1)
    t, e = 512, 8
    probs = rng.random((t, e)).astype(np.float32) * 0.05
    hot = rng.integers(0, 4, t)
    for i, h in enumerate(hot):
        probs[i, 2 * (h // 2)] += 0.5
        probs[i, 2 * (h // 2) + 1] += 0.5
    probs /= probs.sum(1, keepdims=True)
    return probs


# -------------------------------------------- tests/test_pipeline.py's four
def test_token_stream_shapes_and_determinism():
    a = next(synthetic_token_stream(100, 4, 16, seed=3))
    b = next(synthetic_token_stream(100, 4, 16, seed=3))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 16) and a.dtype == np.int32
    assert a.min() >= 0 and a.max() < 100


def test_prefetcher_yields_in_order():
    it = iter([1, 2, 3])
    pf = Prefetcher(it, depth=2)
    assert [next(pf), next(pf), next(pf)] == [1, 2, 3]
    pf.close()
    pf.t.join(timeout=10)
    assert not pf.t.is_alive()


def test_hap_curation_dedups_near_duplicates():
    batch = _near_copies(6, 4, 8)      # 4 near-copies of each base sample
    keep = hap_curate_batch(batch, device="cpu")
    assert 3 <= len(keep) <= 12  # ~6 exemplars << 24 samples


def test_expert_affinity_finds_redundant_experts():
    """Experts 0/1 and 2/3 get identical routing signatures — HAP should
    cluster them together without being told k."""
    res = cluster_experts(_router_probs_reference(), device="cpu")
    assert res.n_clusters < 8
    assert res.labels[0] == res.labels[1]
    assert res.labels[2] == res.labels[3]
    assert res.redundancy > 0.2


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("vocab,batch,seq,seed",
                         [(100, 4, 16, 3), (32_000, 8, 128, 0)])
def test_token_stream_is_bit_equal(vocab, batch, seq, seed):
    from repro.data.pipeline import synthetic_token_stream as j_stream

    a, b = synthetic_token_stream(vocab, batch, seq, seed), \
        j_stream(vocab, batch, seq, seed)
    for _ in range(3):
        np.testing.assert_array_equal(next(a), next(b))


@pytest.mark.parametrize("n_base,copies,d,seed,pref", [
    (6, 4, 8, 0, None), (12, 5, 16, 1, None), (40, 3, 32, 2, None),
    (12, 5, 16, 1, -5.0)])
def test_curation_equals_the_reference(n_base, copies, d, seed, pref):
    from repro.data.pipeline import hap_curate_batch as j_curate

    batch = _near_copies(n_base, copies, d, seed)
    np.testing.assert_array_equal(
        hap_curate_batch(batch, preference=pref, device="cpu"),
        j_curate(batch, preference=pref))


@pytest.mark.parametrize("t,e,seed", [(512, 8, 1), (1024, 16, 2),
                                      (5000, 32, 3)])
def test_expert_clusters_equal_the_reference(t, e, seed):
    from repro.core.expert_affinity import cluster_experts as j_cluster
    from repro.core.expert_affinity import expert_signatures as j_sig

    probs = _router_probs(t, e, seed)
    got, want = cluster_experts(probs, device="cpu"), j_cluster(probs)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.exemplars, want.exemplars)
    assert (got.n_clusters, got.redundancy) == (want.n_clusters,
                                                want.redundancy)
    # every planted pair shares a cluster
    assert (got.labels[0::2] == got.labels[1::2]).all()
    sig = expert_signatures(probs, device="cpu")
    assert sig.shape == (e, min(t, 4096))
    np.testing.assert_allclose(sig.numpy(), np.asarray(j_sig(probs)),
                               rtol=1e-6, atol=1e-7)


def test_hooks_ask_for_a_device():
    """Numpy input runs on ``device``, CUDA by default: without a card that
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hap_curate_batch(_near_copies(3, 2, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cluster_experts(_router_probs())
