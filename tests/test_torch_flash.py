"""The port's flash attention on the CPU against the JAX reference.

On CPU tensors ``ops.flash_attention`` runs the kernel's plain version
(the oracle ``ref.flash_attention``), so these tests hold it against the
Pallas kernel in interpret mode on the reference test's own cases, at the
reference test's tolerances: f32 within 2e-5, bf16 compared in f32 within
3e-2. Where the Pallas kernel is wrong (causal, Sq > Sk, Sk not a multiple
of its block: its zero-padded keys score 0 for the rows >= Sk) the port
follows the oracle, and the test asserts the oracle's answer.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    flash_attention, launch_counts, ops, reset_launch_counts,
)

# tests/test_flash_attention.py's CASES: bh, sq, sk, d, causal, block
CASES = [
    (4, 128, 128, 64, True, 64),
    (2, 100, 100, 32, True, 64),     # non-aligned seq
    (2, 256, 256, 128, False, 128),  # non-causal
    (3, 64, 192, 32, True, 32),      # rectangular (cross-ish)
    (1, 512, 512, 64, True, 128),
]
F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)


def _qkv(seed, bh, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((bh, sq, d), (bh, sk, d), (bh, sk, d))]


@pytest.mark.parametrize("bh,sq,sk,d,causal,blk", CASES)
def test_plain_matches_pallas_kernel_f32(bh, sq, sk, d, causal, blk):
    q, k, v = _qkv(bh * sq + sk, bh, sq, sk, d)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  block_q=blk, block_k=blk, interpret=True)
    got = flash_attention.plain(*map(torch.from_numpy, (q, k, v)), causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_plain_matches_pallas_kernel_bf16():
    q, k, v = _qkv(1, 2, 128, 128, 64)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, causal=True, block_q=64,
                                  block_k=64, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = flash_attention.plain(tq, tk, tv, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("sq,sk", [(600, 300), (100, 70)])
def test_causal_sq_above_ragged_sk_follows_the_oracle(sq, sk):
    """The reference kernel's bug: with Sq > Sk and Sk % block != 0 the
    rows >= Sk also weigh the padded keys. The port gives the oracle's
    answer; the Pallas kernel's differs there."""
    q, k, v = _qkv(sq + sk, 2, sq, sk, 32)
    want = np.asarray(j_ref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), True))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=64, block_k=64, interpret=True))
    assert np.abs(pallas[:, sk:] - want[:, sk:]).max() > 1e-2
    np.testing.assert_allclose(pallas[:, :sk], want[:, :sk], **F32)


def test_noncausal_ragged_sk_runs_where_pallas_refuses():
    q, k, v = _qkv(3, 2, 100, 70, 32)
    with pytest.raises(ValueError, match="non-causal flash requires"):
        flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=False, block_q=64,
                               block_k=64, interpret=True)
    want = j_ref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), False)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_ops_runs_plain_on_cpu_without_counting():
    q, k, v = map(torch.from_numpy, _qkv(4, 3, 70, 90, 16))
    reset_launch_counts()
    got = ops.flash_attention(q, k, v)
    assert torch.equal(got, flash_attention.plain(q, k, v, True))
    assert launch_counts()["flash_attention"] == 0


def test_plain_chunks_over_bh_and_rows_without_keys_give_zero(monkeypatch):
    q, k, v = map(torch.from_numpy, _qkv(5, 5, 40, 30, 8))
    whole = flash_attention.plain(q, k, v, False)
    monkeypatch.setattr(flash_attention, "PLAIN_CHUNK_SCORES", 2 * 40 * 30)
    assert torch.equal(flash_attention.plain(q, k, v, False), whole)
    empty = flash_attention.plain(q, k[:, :0], v[:, :0], True)
    assert empty.shape == q.shape and not bool(empty.any())


def test_shapes_are_checked_on_every_device():
    q = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError, match="must be \\(BH, Sk, D\\)"):
        ops.flash_attention(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError, match="must be \\(BH, S, D\\)"):
        ops.flash_attention(q[0], q[0], q[0])


def test_bound_counts_unmasked_pairs():
    # causal Sq = Sk: S(S+1)/2 per head; Sq > Sk: rows >= Sk see all keys
    assert flash_attention.unmasked_pairs(256, 2048, 2048, True) == \
        256 * 2048 * 2049 // 2
    assert flash_attention.unmasked_pairs(1, 600, 300, True) == \
        300 * 301 // 2 + 300 * 300
    assert flash_attention.unmasked_pairs(1, 192, 320, True) == 192 * 193 // 2
    assert flash_attention.unmasked_pairs(2, 100, 70, False) == 2 * 7000
    for sq, sk, causal in ((600, 300, True), (192, 320, True),
                           (70, 100, False)):
        mask = np.ones((sq, sk), bool)
        if causal:
            mask = np.arange(sq)[:, None] >= np.arange(sk)[None, :]
        assert flash_attention.unmasked_pairs(1, sq, sk, causal) == \
            mask.sum()
    assert flash_attention.operations(256, 2048, 2048, 64, True) == \
        4 * 64 * 256 * 2048 * 2049 // 2
