"""The port's flash attention on the CPU against the JAX reference.

On CPU tensors ``ops.flash_attention`` runs the kernel's plain version
(the oracle ``ref.flash_attention``), so these tests hold it against the
Pallas kernel in interpret mode on the reference test's own cases, at the
reference test's tolerances: f32 within 2e-5, bf16 compared in f32 within
3e-2. Where the Pallas kernel is wrong (causal, Sq > Sk, Sk not a multiple
of its block: its zero-padded keys score 0 for the rows >= Sk) the port
follows the oracle, and the test asserts the oracle's answer.

The CUDA kernel's precision contract is held here through its CPU
emulation ``flash_attention.in_kernel_precision`` (its operand roundings,
and its tensor-core sums, which truncate): with the kernel's split
products (bf16: p as hi + lo; f32: 3xTF32) it stays within
``flash_attention.tolerance`` of the oracle, and with single-pass products
(p rounded to bf16 once; one TF32 pass) it does not.
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


# bh, sq, sk, d, causal, q scale (x4: a concentrated softmax, where a few
# keys carry each row)
PRECISION_CASES = [
    (2, 128, 128, 64, True, 1.0),
    (2, 128, 128, 64, True, 4.0),
    (2, 100, 70, 32, False, 1.0),
    (2, 96, 160, 128, True, 1.0),    # f32: key tiles of 32 rows
]
DTYPES = [torch.float32, torch.bfloat16]


def _scaled(seed, bh, sq, sk, d, scale, dtype):
    q, k, v = map(torch.from_numpy, _qkv(seed, bh, sq, sk, d))
    return [t.to(dtype) for t in (q * scale, k, v)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,sq,sk,d,causal,scale", PRECISION_CASES)
def test_split_products_keep_the_tolerance(bh, sq, sk, d, causal, scale,
                                           dtype):
    q, k, v = _scaled(sq + d, bh, sq, sk, d, scale, dtype)
    want = flash_attention.plain(q, k, v, causal)
    got = flash_attention.in_kernel_precision(q, k, v, causal)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    assert bool((err <= flash_attention.tolerance(want)).all()), \
        float(err.max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,sq,sk,d,causal,scale", PRECISION_CASES)
def test_single_pass_products_miss_the_tolerance(bh, sq, sk, d, causal,
                                                 scale, dtype):
    """Why the kernel splits its products: p rounded to bf16 once, or one
    TF32 pass in f32, puts outputs beyond the tolerance."""
    q, k, v = _scaled(sq + d, bh, sq, sk, d, scale, dtype)
    want = flash_attention.plain(q, k, v, causal)
    got = flash_attention.in_kernel_precision(q, k, v, causal, split=False)
    beyond = (got.float() - want.float()).abs() \
        > flash_attention.tolerance(want)
    assert float(beyond.float().mean()) > 0.01


@pytest.mark.parametrize("bh,sq,sk,d,causal,blk", CASES[:4])
def test_in_kernel_precision_matches_pallas_kernel_f32(bh, sq, sk, d, causal,
                                                       blk):
    q, k, v = _qkv(bh * sq + sk, bh, sq, sk, d)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  block_q=blk, block_k=blk, interpret=True)
    got = flash_attention.in_kernel_precision(
        *map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_tf32_rounding_is_cvt_rna():
    """Nearest, ties away from zero, on the 13 dropped bits; the split's
    small part is exactly representable, so big + small rounds x once
    more at most."""
    one = 1.0
    x = torch.tensor([one, one + 2 ** -11, -(one + 2 ** -11),
                      one + 2 ** -12, one + 3 * 2 ** -11, 2 ** -130,
                      3.0e38], dtype=torch.float32)
    want = torch.tensor([one, one + 2 ** -10, -(one + 2 ** -10), one,
                         one + 2 ** -9, 2 ** -130, 3.0e38],
                        dtype=torch.float32)
    got = flash_attention._tf32(x)
    assert torch.equal(got[:6], want[:6])
    assert float(got[6]) == pytest.approx(3.0e38, rel=2 ** -10)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    big, small = flash_attention._split_tf32(r)
    assert torch.equal(flash_attention._tf32(big), big)
    assert torch.equal(flash_attention._tf32(small), small)
    assert float(((big + small - r).abs() / r.abs()).max()) <= 2 ** -22


def test_mma_model_aligns_and_truncates():
    """One tensor-core step as the emulation models it: products below the
    alignment window of the largest term are dropped, not summed, and
    the sum is truncated to f32."""
    one = torch.ones(1, 1, 1)
    ulp = 2.0 ** -23
    tiny = torch.full((1, 1, 8), 2.0 ** -26)      # below 2 bits under ulp(1)
    eight = torch.ones(1, 8, 1)
    assert float(flash_attention._mma(one, tiny, eight, 2)) == 1.0
    assert float(flash_attention._mma(one, tiny, eight, None)) == 1.0 + ulp
    assert float(flash_attention._mma(
        one, torch.full((1, 1, 1), -2.0 ** -30), one, 2)) == 1.0
    part = torch.full((1, 1, 1), 0.75 * ulp)      # inside the window
    assert float(flash_attention._mma(one, part, one, 2)) == 1.0
    assert float(flash_attention._mma(one, 2 * part, one, 2)) == 1.0 + ulp
    x = torch.tensor([1 + 2.0 ** -24 + 2.0 ** -30, -(1 + 2.0 ** -24)],
                     dtype=torch.float64)
    assert flash_attention._truncate_f32(x).tolist() == [1.0, -1.0]


def test_tiles_and_tensor_core_work():
    assert [flash_attention.padded_d(d) for d in (1, 32, 33, 64, 65, 200,
                                                  256)] == \
        [32, 32, 64, 64, 128, 256, 256]
    assert flash_attention.block_q(64, torch.bfloat16) == 128
    assert flash_attention.block_q(65, torch.bfloat16) == 64
    assert flash_attention.block_q(64, torch.float32) == 64
    assert flash_attention.block_k(64, torch.float32) == 64
    assert flash_attention.block_k(65, torch.float32) == 32
    assert flash_attention.block_k(256, torch.bfloat16) == 64
    pairs = flash_attention.unmasked_pairs(256, 2048, 2048, True)
    assert flash_attention.tensor_core_operations(
        256, 2048, 2048, 64, True, torch.bfloat16) == 6 * 64 * pairs
    assert flash_attention.tensor_core_operations(
        256, 2048, 2048, 64, True, torch.float32) == 12 * 64 * pairs
