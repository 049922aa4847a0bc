"""The port's kernel functions on the CPU against the JAX reference.

On CPU tensors every kernel wrapper runs its plain PyTorch version, so
these tests hold the plain versions (and ``ops``) against
``repro.kernels.ref`` and against the Pallas kernels in interpret mode.

Tolerance ``rtol=1e-5, atol=1e-5`` (scaled by the magnitude where inputs
reach ~100): XLA on the CPU contracts multiply-adds such as the damping
``lam*old + (1-lam)*new`` into FMAs, PyTorch rounds each product, so the
two packages differ by an ulp or two per op. Decisions (argmax indices)
must match exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.affinity import affinity_propagation as j_flat_ap  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.availability import availability_pallas  # noqa: E402
from repro.kernels.responsibility import responsibility_pallas  # noqa: E402
from repro.kernels.similarity import similarity_pallas  # noqa: E402
from repro_torch.core.affinity import affinity_propagation  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    availability, launch_counts, median_select, ops, ref,
    reset_launch_counts, responsibility, similarity, topk_build,
)

import _median_cases  # noqa: E402

SHAPES = [(32, 32), (96, 64), (128, 128), (130, 70), (256, 256), (300, 200)]
AV_SHAPES = [(32, 32), (70, 70), (128, 128), (130, 130), (256, 256)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _resp_inputs(rng, n, m, ties):
    if ties:   # integer-valued: duplicated row maxima everywhere
        s = -rng.integers(0, 4, (n, m)).astype(np.float32)
        a = rng.integers(-2, 3, (n, m)).astype(np.float32)
    else:
        s = -rng.random((n, m)).astype(np.float32) * 10
        a = rng.standard_normal((n, m)).astype(np.float32)
    r_old = rng.standard_normal((n, m)).astype(np.float32)
    tau = rng.standard_normal((n,)).astype(np.float32)
    return s, a, tau, r_old


def _av_inputs(rng, n, ties):
    draw = ((lambda shape: rng.integers(-3, 4, shape).astype(np.float32))
            if ties else
            (lambda shape: rng.standard_normal(shape).astype(np.float32)))
    return draw((n, n)), draw((n,)), draw((n,)), draw((n, n))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(10, 17), (64, 64), (7, 300)])
def test_row_top2_matches_reference(shape, ties, rng):
    v = (rng.integers(-3, 4, shape) if ties
         else rng.standard_normal(shape)).astype(np.float32)
    want = [np.asarray(x) for x in j_ref.row_top2(jnp.asarray(v))]
    got = [x.numpy() for x in ref.row_top2(_t(v))]
    np.testing.assert_array_equal(got[1], want[1])   # first-occurrence argmax
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])   # duplicated max: m2 == m1


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_responsibility_plain_matches_reference(shape, ties, rng):
    s, a, tau, r_old = _resp_inputs(rng, *shape, ties)
    want = j_ref.responsibility(*map(jnp.asarray, (s, a, tau, r_old)), 0.7)
    got = responsibility.responsibility(*map(_t, (s, a, tau, r_old)), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", AV_SHAPES)
def test_availability_plain_matches_reference(shape, ties, rng):
    r, c, phi, a_old = _av_inputs(rng, shape[0], ties)
    want = j_ref.availability(*map(jnp.asarray, (r, c, phi, a_old)), 0.7)
    got = availability.availability(*map(_t, (r, c, phi, a_old)), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    col, diag = ref.col_stats(_t(r))
    jcol, jdiag = j_ref.col_stats(jnp.asarray(r))
    np.testing.assert_allclose(col.numpy(), np.asarray(jcol), **TOL)
    np.testing.assert_array_equal(diag.numpy(), np.asarray(jdiag))


@pytest.mark.parametrize("shape", [(130, 70), (300, 200)])
def test_responsibility_matches_pallas_interpret(shape, rng):
    s, a, tau, r_old = _resp_inputs(rng, *shape, ties=False)
    want = responsibility_pallas(*map(jnp.asarray, (s, a, tau, r_old)), 0.5,
                                 block_i=128, block_j=128, interpret=True)
    got = ops.responsibility(*map(_t, (s, a, tau, r_old)), lam=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [70, 130])
def test_availability_matches_pallas_interpret(n, rng):
    r, c, phi, a_old = _av_inputs(rng, n, ties=False)
    want = availability_pallas(*map(jnp.asarray, (r, c, phi, a_old)), 0.5,
                               block_i=64, block_j=64, interpret=True)
    got = ops.availability(*map(_t, (r, c, phi, a_old)), lam=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 300])
def test_availability_in_kernel_order(n, ties, rng):
    """``availability.in_kernel_order``, which the CUDA kernel must equal
    bit for bit, is the plain version with the kernel's column-sum order:
    its sums lie within the sequential-sum error bound of a float64 sum
    (63 adds in a 64-row chunk, then one per chunk), it is identical to the
    plain version on integer inputs, within ``availability.tolerance`` on
    random ones, and that tolerance stays far below a typical output."""
    if ties:   # mostly negative, as responsibilities are; exact sums
        r = np.where(rng.random((n, n)) < 4.0 / n,
                     rng.integers(1, 4, (n, n)), rng.integers(-8, 1, (n, n)))
        c, phi = rng.integers(-6, 2, n), rng.integers(-6, 2, n)
        a_old = rng.integers(-3, 4, (n, n))
    else:
        r = rng.standard_normal((n, n)) - 3.0
        c, phi = rng.standard_normal(n), rng.standard_normal(n)
        a_old = rng.standard_normal((n, n))
    args = [_t(v.astype(np.float32)) for v in (r, c, phi, a_old)]
    col = availability.col_sums_in_kernel_order(args[0])
    col64 = ref.col_stats(args[0].double())[0]
    n_chunks = -(-n // availability.ROWS_PER_CHUNK)
    bound = (63 + n_chunks) * 2.0 ** -24 * col64 * 1.01
    assert bool(((col.double() - col64).abs() <= bound).all())

    got = availability.in_kernel_order(*args, 0.7)
    want = availability.plain(*args, 0.7)
    if ties:
        assert torch.equal(got, want)
        return
    tol = availability.tolerance(*args[:3], 0.7, want)
    assert bool(((got - want).abs() <= tol).all())
    assert float(tol.median()) <= 1e-4 * float(want.abs().median())


@pytest.mark.parametrize("n,m,d", [(64, 64, 3), (100, 40, 7), (128, 128, 130),
                                   (70, 130, 16)])
def test_similarity_plain_matches_reference_and_pallas(n, m, d, rng):
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal((m, d)).astype(np.float32)
    got = similarity.neg_sqeuclidean(_t(x), _t(y)).numpy()
    want = np.asarray(j_ref.neg_sqeuclidean(jnp.asarray(x), jnp.asarray(y)))
    pallas = np.asarray(similarity_pallas(jnp.asarray(x), jnp.asarray(y),
                                          block_i=64, block_j=64,
                                          interpret=True))
    # values reach ~4d; scale the absolute tolerance with them
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=atol)


def test_similarity_exact_on_integer_pixels(rng):
    """RGB-like integers: every partial sum is an exact integer < 2**24."""
    x = rng.integers(0, 256, (90, 3)).astype(np.float32)
    got = ops.neg_sqeuclidean(_t(x)).numpy()
    want = np.asarray(j_ref.neg_sqeuclidean(jnp.asarray(x), jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_wrappers_take_plain_version_on_cpu_without_counting(rng):
    s, a, tau, r_old = _resp_inputs(rng, 40, 40, ties=True)
    reset_launch_counts()
    out = torch.empty(40, 40)
    got = responsibility.responsibility(*map(_t, (s, a, tau, r_old)), 0.5,
                                        out=out)
    assert got is out
    np.testing.assert_array_equal(
        out.numpy(), ref.responsibility(*map(_t, (s, a, tau, r_old)),
                                        0.5).numpy())
    ops.neg_sqeuclidean(_t(s[:, :3]))
    ops.availability(_t(r_old), _t(tau), _t(tau), _t(a), lam=0.5)
    topk_build.topk_similarity_fused(_t(s[:, :3]), 5)
    ops.flash_attention(_t(s[None]), _t(a[None]), _t(r_old[None]))
    median_select.middle_pair(_t(s), skip_diagonal=True)
    assert launch_counts() == {"similarity": 0, "responsibility": 0,
                               "availability": 0, "topk_build": 0,
                               "flash_attention": 0, "median_select": 0}


@pytest.mark.parametrize("call", [
    lambda t: similarity.neg_sqeuclidean(t, t[:, :3]),
    lambda t: responsibility.responsibility(t, t, t[0], t, 0.5),
    lambda t: availability.availability(t, t[0], t[0], t, 0.5),
    lambda t: topk_build.topk_similarity_fused(t, 5),
    lambda t: median_select.middle_pair(t, skip_diagonal=True),
])
def test_wrappers_never_fall_back_off_the_cpu(call):
    """A tensor on another device gets the kernel or an error, never the
    plain version: here the 'meta' device, which has no kernel."""
    with pytest.raises(ValueError, match="no kernel for device"):
        call(torch.empty(8, 8, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        responsibility.responsibility(torch.zeros(4, 4),
                                      torch.zeros(4, 4, device="meta"),
                                      torch.zeros(4), torch.zeros(4, 4), 0.5)


@pytest.mark.parametrize("layout", _median_cases.LAYOUTS,
                         ids=lambda lay: f"{lay[0][0]}x{lay[0][1]}"
                         f"{'-offdiag' if lay[1] else ''}")
@pytest.mark.parametrize("kind", _median_cases.KINDS)
def test_median_select_digit_walk_matches_kthvalue(kind, layout):
    """The median-select kernel's digit walk in plain PyTorch (its keys,
    per-digit histograms, two-rank narrowing and mean) picks the two
    middle order statistics ``torch.kthvalue`` picks, equal under ``==``,
    and the mean the plain version (today's two ``kthvalue`` calls)
    gives, which the wrapper takes on the CPU."""
    shape, skip = layout
    x = _t(_median_cases.values(kind, shape, skip, seed=sum(shape)))
    vals = ref.off_diagonal(x) if skip else x.reshape(-1)
    cnt = vals.numel()
    want = [torch.kthvalue(vals, k).values
            for k in ((cnt - 1) // 2 + 1, cnt // 2 + 1)]
    got = ref.middle_pair_by_digits(x, skip_diagonal=skip)
    assert got[0] == want[0] and got[1] == want[1]
    plain = median_select.middle_pair(x, skip_diagonal=skip)
    assert torch.equal(got, plain)
    assert plain[2] == 0.5 * (want[0] + want[1])


def test_median_select_keys_order_as_kthvalue():
    """The key map is monotone over every ordered class of float32 and
    maps back to the value (-0.0 to +0.0, every NaN to a NaN above
    +inf)."""
    v = torch.tensor([-np.inf, -3.4e38, -1.0, -1e-45, -0.0, 0.0, 1e-45,
                      1.0, 3.4e38, np.inf, np.nan, -np.nan])
    keys = ref.radix_keys(v)
    assert keys.tolist() == sorted(keys.tolist())
    assert len(set(keys[:10].tolist())) == 9
    assert keys[4] == keys[5] and keys[10] == keys[11] == 0xFFFFFFFF
    back = ref.key_values(keys)
    assert torch.equal(back[:10], v[:10]) and bool(back[10:].isnan().all())
    assert str(float(back[4])) == "0.0"


def test_hap_iteration_kernels_matches_reference(rng):
    n = 64
    s = (-rng.random((n, n)) * 5).astype(np.float32)
    r = rng.standard_normal((n, n)).astype(np.float32)
    a = rng.standard_normal((n, n)).astype(np.float32)
    tau = rng.standard_normal(n).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    phi = rng.standard_normal(n).astype(np.float32)
    jr, ja = j_ops.hap_iteration_kernels(
        *map(jnp.asarray, (s, r, a, tau, c, phi)), lam=0.5, block=32)
    tr, ta = ops.hap_iteration_kernels(*map(_t, (s, r, a, tau, c, phi)),
                                       lam=0.5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)


def test_affinity_propagation_kernels_matches_flat_ap():
    """Flat AP built from the kernel ops == the port's flat AP == the
    reference's flat AP, in decisions; messages within tolerance."""
    from repro.core.preferences import median_preference
    from repro.core.similarity import pairwise_similarity, set_preferences
    from repro.data import gaussian_blobs
    x, _ = gaussian_blobs(n=96, k=3, seed=11)
    s = pairwise_similarity(jnp.asarray(x))
    s = np.asarray(set_preferences(s, median_preference(s)))
    want = j_flat_ap(jnp.asarray(s), iterations=40, damping=0.5)
    flat = affinity_propagation(_t(s), iterations=40, damping=0.5)
    e, r, a = ops.affinity_propagation_kernels(_t(s), iterations=40, lam=0.5)
    np.testing.assert_array_equal(e.numpy(), np.asarray(want.exemplars))
    np.testing.assert_array_equal(flat.exemplars.numpy(),
                                  np.asarray(want.exemplars))
    assert int(flat.n_clusters) == int(want.n_clusters)
    np.testing.assert_allclose(r.numpy(), np.asarray(want.r),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(flat.a.numpy(), np.asarray(want.a),
                               rtol=1e-4, atol=1e-4)
