"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``; every test skips (from a fixture, so all workers collect
the same tests) when no CUDA device is present. This file imports no JAX
so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: responsibility rounds every operation as the plain version
does (max/argmax are order-independent), so it must be bit-identical.
Availability must equal ``availability.in_kernel_order`` (the plain
version with the kernel's summation order) bit for bit; its column sums
run in another order than PyTorch's, so against the plain version it is
bit-identical on integer-valued inputs (every partial sum is exact) and
within ``availability.tolerance`` (the measured column-sum gap) on random
ones.
Similarity is exact on integer data and within ``similarity.tolerance``
on random data.
The fused top-k build computes each similarity in the similarity kernel's
order, so it must equal ``topk_build.in_kernel_order`` and the reference
scan on the card (whose tiles the similarity kernel computes) bit for bit;
against ``topk_build.plain`` (a matmul) it is held by
``topk_build.compare_with_plain``: values within ``topk_build.tolerance``
and columns equal wherever a row's k-th and (k+1)-th values are not a
near-tie. The top-k column sums are summed in a fixed order: two runs are
bit-identical, and equal to the CPU's.
Flash attention accumulates in f32 in another order than its plain
version (cuBLAS products, a softmax), with split tensor-core products
(bf16: p as hi + lo; f32: 3xTF32): within ``flash_attention.tolerance``
(the reference test's 2e-5 + 2e-5 |out| in f32; in bf16, compared in the
working type, one bf16 rounding step more) of the plain version and of
``flash_attention.in_kernel_precision``, the kernel's roundings in plain
PyTorch (in f32 within a quarter of the tolerance). The two-stage top-k build
computes its similarities in the reference scan's fixed order: equal to
the scan on the card bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _median_cases  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    availability, flash_attention, launch_counts, median_select, ops, ref,
    reset_launch_counts, responsibility, similarity, topk_build, topk_ops,
)
from repro_torch.kernels.topk_similarity import (  # noqa: E402
    topk_similarity, topk_similarity_twostage,
)
from repro_torch.graph import EdgeList, affinity  # noqa: E402
from repro_torch.runtime import faultinject  # noqa: E402
from repro_torch.solver import SolveConfig, solve  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (64, 64, 3), (100, 40, 7),
                                   (130, 70, 130), (517, 1031, 33)])
def test_similarity_kernel(dev, n, m, d):
    rng = _gen(n + m + d)
    for ints in (True, False):
        x = (rng.integers(0, 256, (n, d)) if ints
             else rng.standard_normal((n, d))).astype(np.float32)
        y = (rng.integers(0, 256, (m, d)) if ints
             else rng.standard_normal((m, d))).astype(np.float32)
        xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        got = similarity.neg_sqeuclidean(xt, yt)
        want = similarity.plain(xt, yt)
        torch.cuda.synchronize()
        if ints:
            assert torch.equal(got, want)
        else:
            tol = similarity.tolerance(xt, yt)
            assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("n,m", [(1, 1), (3, 300), (257, 129), (1000, 1000),
                                 (5, 60000)])
@pytest.mark.parametrize("ints", [True, False])
def test_responsibility_kernel_bit_identical(dev, n, m, ints):
    rng = _gen(n * m)
    if ints:
        s = -rng.integers(0, 4, (n, m)).astype(np.float32)
        a = rng.integers(-2, 3, (n, m)).astype(np.float32)
    else:
        s = -rng.random((n, m)).astype(np.float32) * 10
        a = rng.standard_normal((n, m)).astype(np.float32)
    r_old = rng.standard_normal((n, m)).astype(np.float32)
    tau = rng.standard_normal(n).astype(np.float32)
    tau[::3] = np.inf
    args = [torch.from_numpy(v).to(dev) for v in (s, a, tau, r_old)]
    got = responsibility.responsibility(*args, 0.7)
    want = responsibility.plain(*args, 0.7)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _availability_inputs(rng, n, ints):
    """Mostly negative r, as responsibilities are, so that column sums stay
    small and min(0, .) in Eq 2.2 is often negative off the diagonal."""
    if ints:   # about 4 positive entries per column; every sum is exact
        r = np.where(rng.random((n, n)) < 4.0 / n,
                     rng.integers(1, 4, (n, n)), rng.integers(-8, 1, (n, n)))
        c, phi = rng.integers(-6, 2, n), rng.integers(-6, 2, n)
        a_old = rng.integers(-3, 4, (n, n))
    else:
        r = rng.standard_normal((n, n)) - 3.0
        c, phi = rng.standard_normal(n), rng.standard_normal(n)
        a_old = rng.standard_normal((n, n))
    return [v.astype(np.float32) for v in (r, c, phi, a_old)]


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 300, 1031])
@pytest.mark.parametrize("ints", [True, False])
def test_availability_kernel(dev, n, ints):
    args = [torch.from_numpy(v).to(dev)
            for v in _availability_inputs(_gen(n), n, ints)]
    got = availability.availability(*args, 0.7)
    again = availability.availability(*args, 0.7)
    want = availability.plain(*args, 0.7)
    torch.cuda.synchronize()
    assert torch.equal(got, again)            # fixed order: re-runs agree
    assert torch.equal(got, availability.in_kernel_order(*args, 0.7))
    if ints:
        assert torch.equal(got, want)
    else:
        tol = availability.tolerance(*args[:3], 0.7, want)
        assert bool(((got - want).abs() <= tol).all())
    if n >= 63:   # both branches of min(0, .) occur off the diagonal
        fresh = availability.plain(*args[:3], torch.zeros_like(args[0]), 0.0)
        off = ~torch.eye(n, dtype=torch.bool, device=dev)
        assert bool((fresh[off] < 0).any()) and bool((fresh[off] == 0).any())


def test_argmax_takes_first_occurrence_on_cuda(dev):
    """The plain versions and the assignment step rely on it, as the
    reference relies on ``jnp.argmax``."""
    v = torch.tensor([[1.0, 5.0, 5.0, 2.0], [3.0, 3.0, 3.0, 3.0],
                      [0.0, -1.0, 0.0, 0.0]], device=dev)
    assert torch.argmax(v, dim=1).tolist() == [1, 0, 0]
    long_rows = torch.zeros(3, 100_000, device=dev)
    long_rows[:, [7, 50_000, 99_999]] = 1.0     # reduced over many threads
    assert torch.argmax(long_rows, dim=1).tolist() == [7, 7, 7]


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(8, 8, device=dev)
    with pytest.raises(TypeError, match="float32"):
        similarity.neg_sqeuclidean(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        responsibility.responsibility(x.T, x, x[0], x, 0.5)
    with pytest.raises(ValueError, match="shape"):
        availability.availability(x, x[0, :4], x[0], x, 0.5)
    with pytest.raises(TypeError, match="float32"):
        topk_build.topk_similarity_fused(x.double(), 3)
    with pytest.raises(ValueError, match="k must be in"):
        topk_build.topk_similarity_fused(x, 8)


def test_fused_solve_goes_through_the_kernels(dev):
    rng = _gen(7)
    x = rng.integers(0, 256, (300, 3)).astype(np.float32)
    reset_launch_counts()
    fused = solve(x, backend="dense_fused", max_iterations=20)
    counts = launch_counts()
    plain = solve(x, backend="dense_parallel", max_iterations=20)
    assert counts == {"similarity": 1, "responsibility": 3 * 20,
                      "availability": 3 * 20, "topk_build": 0,
                      "flash_attention": 0, "median_select": 1}
    np.testing.assert_array_equal(fused.n_clusters, plain.n_clusters)
    assert (fused.exemplars != plain.exemplars).mean() <= 1e-3


def _topk_points(rng, n, d, kind):
    if kind == "random":
        return rng.standard_normal((n, d)).astype(np.float32)
    x = rng.integers(0, 256 if kind == "integer" else 3, (n, d))
    if kind == "duplicate":
        x[n // 3:n // 3 + n // 5] = x[:n // 5]
    return x.astype(np.float32)


@pytest.mark.parametrize("n,d,k", [
    (2, 1, 1), (33, 2, 32), (130, 3, 129), (130, 3, 5), (257, 64, 64),
    (1001, 3, 64), (700, 5, 699), (1500, 2, 650), (4099, 64, 129),
    (1500, 1, 640), (999, 4, 64), (700, 7, 641), (777, 8, 100),
    (701, 15, 640), (333, 16, 17), (1027, 2, 641)])
@pytest.mark.parametrize("kind", ["random", "integer", "duplicate"])
def test_topk_build_kernel_bit_identical(dev, n, d, k, kind):
    """Every feature bucket of the kernel (d = 1, 2, 3 exactly; 4-7 and
    8-15 zero-padded; the staged path from 16), k = N - 1, k on both sides
    of the shared-memory lists (640), and N a multiple of neither the rows
    of a block nor the 128-column step."""
    x = torch.from_numpy(_topk_points(_gen(n * d + k), n, d, kind)).to(dev)
    got = topk_build.topk_similarity_fused(x, k)
    again = topk_build.topk_similarity_fused(x, k)
    torch.cuda.synchronize()
    for want in (again, topk_build.in_kernel_order(x, k),
                 topk_similarity(x, k)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int32
    assert bool((got[1][:, 1:] > got[1][:, :-1]).all())
    assert not bool((got[1] == torch.arange(n, device=dev)[:, None]).any())


@pytest.mark.parametrize("n,d,k", [(1001, 3, 64), (2049, 64, 129),
                                   (3000, 2, 16)])
def test_topk_build_kernel_against_plain(dev, n, d, k):
    x = torch.from_numpy(_topk_points(_gen(n + d), n, d, "random")).to(dev)
    vals, idx = topk_build.topk_similarity_fused(x, k)
    got = topk_build.compare_with_plain(x, k, vals, idx)
    assert got["values_within_tolerance"], got
    assert got["idx_equal_off_ties"], got
    xi = torch.from_numpy(_topk_points(_gen(n), n, d, "integer")).to(dev)
    vals, idx = topk_build.topk_similarity_fused(xi, k)
    assert topk_build.compare_with_plain(xi, k, vals, idx)["bit_identical"]


def test_topk_col_stats_fixed_order_on_cuda(dev):
    """Two runs give bit-identical column sums, equal to the CPU's (both
    sum each column's incoming edges sequentially in row-major order),
    with a hub column that takes a third of all edges."""
    rng = _gen(5)
    n, kk = 20_000, 65
    idx = np.sort(rng.integers(0, n, (n, kk)), axis=1)
    idx[:, 1:22] = np.sort(np.where(rng.random((n, 21)) < 0.5, 7,
                                    idx[:, 1:22]), axis=1)
    idx[:, 0] = np.arange(n)
    r = rng.standard_normal((3, n, kk)).astype(np.float32)
    idx_t, r_t = torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(r)
    want, _ = topk_ops.col_stats_topk(r_t, topk_ops.incoming_edges(idx_t))
    edges = topk_ops.incoming_edges(idx_t.to(dev))
    one, _ = topk_ops.col_stats_topk(r_t.to(dev), edges)
    two, _ = topk_ops.col_stats_topk(r_t.to(dev), edges)
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    assert torch.equal(one.cpu(), want)


def test_topk_solve_goes_through_the_kernel(dev):
    rng = _gen(9)
    x = rng.integers(0, 256, (9000, 3)).astype(np.float32)
    reset_launch_counts()
    fused = solve(x, max_iterations=20)
    counts = launch_counts()
    assert fused.backend == "dense_topk"
    assert counts == {"similarity": 0, "responsibility": 0,
                      "availability": 0, "topk_build": 1,
                      "flash_attention": 0, "median_select": 1}
    ref = solve(x, max_iterations=20, build="reference")
    np.testing.assert_array_equal(fused.exemplars, ref.exemplars)
    np.testing.assert_array_equal(fused.trace, ref.trace)


def _dup_heavy_edges(rng, n, weights=(1.0, 2.0, 3.0)):
    """A canonical random graph whose weights come from a 3-value set:
    nearly every selection is a tie."""
    m = 6 * n
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.choice(np.asarray(weights, np.float32), m)
    return EdgeList(src, dst, w, n).canonical()


@pytest.mark.parametrize("n,target,levels", [
    (120, 1, 3), (2000, 1, 2), (5000, 40, 1), (30000, 1, 3)])
def test_boruvka_on_cuda_equals_the_cpu(dev, n, target, levels):
    vals, idx = _dup_heavy_edges(_gen(n), n).to_topk()
    obs.reset_counters("host_copies.graph_affinity")
    got = affinity.run_graph_affinity(
        torch.from_numpy(vals).to(dev), torch.from_numpy(idx).to(dev),
        levels=levels, target=target)
    reads = obs.counters()["host_copies.graph_affinity"]
    want = affinity.run_graph_affinity(
        torch.from_numpy(vals), torch.from_numpy(idx), levels=levels,
        target=target)
    assert got[0].is_cuda
    assert torch.equal(got[0].cpu(), want[0])
    assert got[1:3] == want[1:3] and reads == got[1]
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("kind", ["random", "integer", "duplicate"])
def test_edge_list_from_points_on_cuda_equals_the_scan(dev, kind):
    x = _topk_points(_gen(12), 3000, 3, kind)
    reset_launch_counts()
    el = EdgeList.from_points(torch.from_numpy(x).to(dev), 16)
    assert launch_counts()["topk_build"] == 1
    vals, idx = topk_similarity(torch.from_numpy(x).to(dev), 16)
    want = EdgeList.from_topk(vals.cpu().numpy(), idx.cpu().numpy())
    again = EdgeList.from_points(x, 16)             # numpy: on "cuda"
    for f in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(el, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(again, f), getattr(want, f))


@pytest.mark.parametrize("stop,levels", [("fixed", 3), ("converged", 1)])
def test_topk_crash_resume_on_cuda_is_bit_exact(dev, tmp_path, stop,
                                                levels):
    x = _gen(13).integers(0, 256, (9000, 3)).astype(np.float32)
    cfg = SolveConfig(backend="dense_topk", stop=stop, levels=levels,
                      max_iterations=30, checkpoint_every=7,
                      checkpoint_dir=str(tmp_path / "ck"), keep_state=True)
    plain = solve(x, cfg.replace(checkpoint_every=0, checkpoint_dir=None))
    inj = faultinject.FaultInjector().add(
        faultinject.Rule("solver.sweep", nth=1))
    with faultinject.active(inj), pytest.raises(faultinject.InjectedFault):
        solve(x, cfg)
    res = solve(x, cfg.replace(resume_from=cfg.checkpoint_dir))
    np.testing.assert_array_equal(res.exemplars, plain.exemplars)
    np.testing.assert_array_equal(res.trace, plain.trace)
    assert (res.n_sweeps, res.converged) == (plain.n_sweeps, plain.converged)
    for got, want in zip(res.state.hap, plain.state.hap):
        assert got.is_cuda and torch.equal(got, want)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,causal,scale", [
    (3, 100, 100, True, 1.0), (2, 1000, 1000, True, 1.0),
    (2, 1000, 1000, False, 1.0), (2, 192, 320, True, 1.0),
    (2, 600, 300, True, 1.0), (2, 70, 130, False, 1.0),
    (1, 1, 1, True, 1.0), (2, 512, 512, True, 4.0)])
def test_flash_attention_kernel(dev, d, dtype, bh, sq, sk, causal, scale,
                                record_property):
    """Every head-dim bucket in both dtypes: ragged Sq and Sk against the
    64-row tiles, non-causal, Sq > Sk (rows >= Sk see every key), Sq < Sk,
    and a concentrated softmax (q x 4). Within the tolerance of the oracle
    and of the kernel's emulation ``in_kernel_precision``; in f32 within a
    quarter of it from the emulation, which must reproduce the tensor
    cores' truncating sums for that. The largest error against each, and
    its share of the tolerance, go to the JUnit report's properties
    (``--junitxml``)."""
    g = torch.Generator(device=dev).manual_seed(bh * sq + sk + d)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=dev)
               for s in (sq, sk, sk))
    q, k, v = (t.to(dtype) for t in (q * scale, k, v))
    reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal)
    assert launch_counts()["flash_attention"] == 1
    want = flash_attention.plain(q, k, v, causal)
    emulated = flash_attention.in_kernel_precision(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    for name, ref in (("plain", want), ("emulation", emulated)):
        err = (got.float() - ref.float()).abs()
        tol = flash_attention.tolerance(ref)
        record_property(f"max_err_{name}", float(err.max()))
        record_property(f"max_err_over_tolerance_{name}",
                        float((err / tol).max()))
        assert bool((err <= tol).all()), float(err.max())
    if dtype == torch.float32:
        assert bool((err <= tol / 4).all()), float(err.max())
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("d", [64, 256])
def test_flash_attention_f32_follows_the_tensor_cores_sums(dev, d,
                                                           record_property):
    """Of the emulation's models of a tensor-core step (``align_bits``:
    None = exact sums rounded to nearest; else that many bits kept below
    f32's last place, the rest truncated), ``MMA_ALIGN_BITS`` lies nearest
    the kernel, and at a quarter of the exact model's mean distance or
    less: the kernel's f32 error beyond the operand roundings is the
    truncation. Causal, q x 4. Mean distances go to the JUnit report."""
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (torch.randn(2, 512, d, generator=g, device=dev)
               for _ in range(3))
    q = q * 4.0
    got = ops.flash_attention(q, k, v, causal=True)
    dist = {}
    for bits in (None, 0, 1, 2, 3):
        emulated = flash_attention.in_kernel_precision(q, k, v, True,
                                                       align_bits=bits)
        dist[bits] = float((got - emulated).abs().mean())
        record_property(f"mean_dist_align_bits_{bits}", dist[bits])
    record_property("mean_err_plain", float(
        (got - flash_attention.plain(q, k, v, True)).abs().mean()))
    best = flash_attention.MMA_ALIGN_BITS
    assert dist[best] == min(dist.values()), dist
    assert dist[best] <= dist[None] / 4, dist


def test_flash_attention_odd_head_dims(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    for d in (1, 5, 33, 200, 255):
        q, k, v = (torch.randn(2, s, d, generator=g, device=dev)
                   for s in (77, 55, 55))
        got = ops.flash_attention(q, k, v)
        want = flash_attention.plain(q, k, v, True)
        assert bool(((got - want).abs()
                     <= flash_attention.tolerance(want)).all()), d


def test_flash_attention_rejects_what_the_kernel_does_not_take(dev):
    x = torch.zeros(2, 8, 16, device=dev)
    with pytest.raises(TypeError, match="float32 or"):
        ops.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(TypeError, match="float32 or"):
        ops.flash_attention(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(x.transpose(1, 2).contiguous().transpose(1, 2),
                            x, x)
    wide = torch.zeros(2, 8, 257, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="must be \\(BH, Sk, D\\)"):
        ops.flash_attention(x, x[:, :, :8], x[:, :, :8])
    with pytest.raises(ValueError, match="several devices"):
        ops.flash_attention(x, x.cpu(), x)


@pytest.mark.parametrize("metric", ["neg_sqeuclidean", "neg_euclidean",
                                    "cosine"])
@pytest.mark.parametrize("kind", ["integer", "duplicate", "random"])
def test_twostage_bit_identical_to_the_scan_on_cuda(dev, metric, kind):
    x = torch.from_numpy(_topk_points(_gen(11), 3000, 3, kind)).to(dev)
    got = topk_similarity_twostage(x, 16, metric=metric, block_rows=512,
                                   chunk=32, round_chunks=4, max_rounds=2,
                                   residual_chunks=8)
    want = topk_similarity(x, 16, metric=metric)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kind != "random" and metric == "neg_sqeuclidean":
        # exact integer arithmetic: the CPU's scan agrees too (a square
        # root or a division may round apart between the two devices)
        cpu = topk_similarity(x.cpu(), 16, metric=metric)
        assert torch.equal(got[0].cpu(), cpu[0])
        assert torch.equal(got[1].cpu(), cpu[1])


# ------------------------------------------------------------ median select
def _kthvalue_pair(x, skip):
    """The two middle order statistics by ``torch.kthvalue`` on the card."""
    vals = ref.off_diagonal(x) if skip else x.reshape(-1)
    cnt = vals.numel()
    return [torch.kthvalue(vals, k).values
            for k in ((cnt - 1) // 2 + 1, cnt // 2 + 1)]


def _assert_select_equals_kthvalue(x, skip):
    got = median_select.middle_pair(x, skip_diagonal=skip)
    lo, hi = _kthvalue_pair(x, skip)
    torch.cuda.synchronize()
    assert got[0] == lo and got[1] == hi
    assert got[2] == 0.5 * (lo + hi)
    assert torch.equal(got[2], ref.middle_pair(x, skip_diagonal=skip)[2])


@pytest.mark.parametrize("layout", [*_median_cases.LAYOUTS,
                                    ((2048, 2048), True), ((509, 65), False)],
                         ids=lambda lay: f"{lay[0][0]}x{lay[0][1]}"
                         f"{'-offdiag' if lay[1] else ''}")
@pytest.mark.parametrize("kind", _median_cases.KINDS)
def test_median_select_equals_kthvalue(dev, kind, layout):
    """The kernel's two order statistics equal ``torch.kthvalue``'s under
    ``==`` and its mean the plain version's, on every input family, from
    two values up to the sampled median's 2,048 x 2,048 subsample."""
    shape, skip = layout
    x = torch.from_numpy(_median_cases.values(kind, shape, skip,
                                              seed=sum(shape))).to(dev)
    _assert_select_equals_kthvalue(x, skip)


def test_median_select_on_the_mandrill(dev):
    """At the dense cell's size: the 10,609 x 10,609 similarities of the
    Mandrill-like image, 112.5 M off-diagonal values."""
    from repro_torch.core import pairwise_similarity
    from repro_torch.data import image_to_points, mandrill_like_image

    x = torch.from_numpy(image_to_points(mandrill_like_image(103, 103)))
    s = pairwise_similarity(x.to(dev))
    _assert_select_equals_kthvalue(s, True)


def test_median_select_skips_the_diagonal(dev):
    """A diagonal of +inf and one of -inf give the same answer, that of
    the off-diagonal entries alone."""
    rng = _gen(5)
    x = torch.from_numpy(rng.standard_normal((301, 301)).astype(np.float32))
    got = []
    for fill in (np.inf, -np.inf):
        y = x.clone()
        y.fill_diagonal_(fill)
        got.append(median_select.middle_pair(y.to(dev), skip_diagonal=True))
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0].cpu(), ref.middle_pair(x, skip_diagonal=True))


@pytest.mark.parametrize("preference,launches", [("median", 1),
                                                 ("random", 0)])
def test_median_select_launches_once_per_median_solve(dev, preference,
                                                      launches):
    x = _gen(8).integers(0, 256, (500, 3)).astype(np.float32)
    reset_launch_counts()
    solve(x, backend="dense_fused", max_iterations=5, preference=preference)
    assert launch_counts()["median_select"] == launches


def test_median_select_adds_no_host_sync(dev):
    """Under ``set_sync_debug_mode("error")`` the median preference raises
    nothing: no value comes to the host."""
    from repro_torch.core.preferences import median_preference

    s = -torch.from_numpy(_gen(3).random((700, 700)).astype(np.float32))
    s = s.to(dev)
    median_preference(s)                   # the library is built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pref = median_preference(s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(pref.cpu(), median_preference(s.cpu()))


# ------------------------------------------------------- the cluster service
SERVE_KW = dict(stop="converged", max_iterations=80, damping=0.6, levels=2,
                preference="median")


def _serve_requests():
    from repro_torch.data import gaussian_blobs
    reqs = []
    for i, n in enumerate((40, 64, 90, 128, 55, 120)):
        x, _ = gaussian_blobs(n=n, k=4, seed=30 + i, spread=0.3, box=14.0)
        reqs.append((x, "s" if i % 2 == 0 else None))
    return reqs


def _serve(device, reqs):
    from repro_torch.serve.cluster import ClusterService
    svc = ClusterService(config=SolveConfig(**SERVE_KW, device=device),
                         buckets=[(64, 2, 4), (128, 2, 4)],
                         auto_bucket=False)
    svc.warmup()
    futs = [svc.submit(x, stream=s) for x, s in reqs]
    svc.drain()
    futs += [svc.submit(x, stream=s) for x, s in reqs]   # the fast path
    svc.drain()
    return svc, [f.result(timeout=60) for f in futs]


def test_service_on_cuda_decides_as_on_the_cpu(dev, record_property):
    """A warmed service on the card answers a mixed batch (micro-batches
    in two buckets, stream fast-path riders) with the decisions of the
    same service on the CPU: labels, exemplars, sweep counts and flags;
    its batched path launches no kernel. S's product runs in cuBLAS on
    the card and in the CPU's BLAS there, which round differently, so the
    intermediate sweeps' change counts (the trace) can differ where a
    border point or an inert padding row flips; the trace's length and a
    converged request's closing run of ``patience`` zeros are equal, and
    the largest gap is recorded in the report."""
    reqs = _serve_requests()
    reset_launch_counts()
    gpu, got = _serve(None, reqs)
    assert sum(launch_counts().values()) == 0
    assert {w.device.type for w in gpu.workers} == {"cuda"}
    cpu, want = _serve("cpu", reqs)
    assert gpu.snapshot()["cache"]["misses"] == 6     # warmup only
    patience, gap = gpu.config.patience, 0
    for g, w in zip(got, want):
        assert (g.path, g.bucket, g.generation) == (w.path, w.bucket,
                                                    w.generation)
        np.testing.assert_array_equal(g.labels, w.labels)
        if w.solve is not None:
            np.testing.assert_array_equal(g.solve.exemplars,
                                          w.solve.exemplars)
            assert g.solve.n_sweeps == w.solve.n_sweeps
            assert g.solve.converged == w.solve.converged
            assert len(g.solve.trace) == len(w.solve.trace)
            if w.solve.converged:
                assert not g.solve.trace[-patience:].any()
            gap = max(gap, int(np.abs(g.solve.trace.astype(np.int64)
                                      - w.solve.trace).max(initial=0)))
    record_property("largest_trace_gap", gap)


def test_service_overflow_launches_the_topk_kernel_once(dev):
    """A request past ``max_bucket_n`` runs one dense_topk solve on the
    worker's card: one ``topk_build`` launch, and the decisions of a
    direct solve with the same config."""
    from repro_torch.data import gaussian_blobs
    from repro_torch.serve.cluster import ClusterService

    cfg = SolveConfig(**SERVE_KW)
    svc = ClusterService(config=cfg, buckets=[(64, 2, 4)],
                         auto_bucket=False, max_bucket_n=64)
    x, _ = gaussian_blobs(n=6000, k=8, seed=1, spread=0.5)
    reset_launch_counts()
    res = svc.solve_sync(x, stream="big")
    # one sampled median for the solve, one for the stream's preference
    assert launch_counts() == {"similarity": 0, "responsibility": 0,
                               "availability": 0, "topk_build": 1,
                               "flash_attention": 0, "median_select": 2}
    assert res.bucket is None and res.solve.backend == "dense_topk"
    direct = solve(x, cfg.replace(backend="dense_topk", k=64,
                                  input_kind="points"))
    np.testing.assert_array_equal(res.solve.exemplars, direct.exemplars)
    np.testing.assert_array_equal(res.solve.trace, direct.trace)
    assert svc.snapshot()["overflow_solves"] == 1


def test_service_worker_fault_resolves_every_future_on_cuda(dev):
    """A ``serve.launch`` fault on a scheduler thread: the riders retry on
    the other worker, and every future resolves with a result."""
    from repro_torch.data import gaussian_blobs
    from repro_torch.runtime.faultinject import FaultInjector, Rule
    from repro_torch.serve.cluster import ClusterService

    svc = ClusterService(config=SolveConfig(**SERVE_KW),
                         buckets=[(64, 2, 2)], auto_bucket=False,
                         workers=2, max_wait_ms=1.0,
                         worker_cooldown_s=0.05, retry_backoff_ms=1.0)
    svc.warmup()
    inj = FaultInjector().add(Rule("serve.launch", nth=0,
                                   match={"worker": 1}))
    svc.start()
    try:
        with faultinject.active(inj):
            futs = [svc.submit(gaussian_blobs(n=40, k=4, seed=s,
                                              spread=0.3)[0])
                    for s in range(10)]
            for f in futs:
                assert f.result(timeout=120).path == "full"
    finally:
        svc.stop(timeout=30)
    assert len(inj.events) == 1
    assert svc.stats.worker_deaths == 1
    assert svc.stats.retried_batches >= 1


# ------------------------------------------------------------- distributed
def _cuda_ranks(x, s3):
    """One rank of a 2-rank group on the card (gloo, host-staged)."""
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.sharding import dist
    from repro_torch.solver.topk_build import sharded_topk_similarity

    mesh = make_worker_mesh()
    ax = mesh.axis("workers")
    block = torch.arange(24.0).reshape(2, 3, 4) * (dist.rank() + 1) - 5.0
    out = {"transport": mesh.transport,
           "device": torch.cuda.current_device()}
    for where in ("cpu", "cuda"):
        t = block.to(where)
        got = [dist.all_gather(t, ax, axis=1),
               dist.all_gather(t, ax, axis=0, tiled=False),
               dist.all_to_all(t, ax, split_axis=2, concat_axis=1),
               dist.pmax(t, ax), dist.pmin(t, ax), dist.psum(t, ax)]
        out[where] = [(g.device.type, g.cpu().numpy()) for g in got]
    out["solve"] = solve(s3, backend="mr1d_stats", max_iterations=30,
                         damping=0.6).exemplars
    reset_launch_counts()
    vals, idx = sharded_topk_similarity(torch.from_numpy(x).cuda(), 16,
                                        SolveConfig(), mesh=mesh)
    out["launches"] = launch_counts()
    out["build"] = (vals.cpu().numpy(), idx.cpu().numpy())
    return out


@pytest.fixture(scope="module")
def cuda_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import pairwise_similarity, set_preferences
    from repro_torch.core import stack_levels
    from repro_torch.core.preferences import median_preference
    from repro_torch.data import gaussian_blobs
    from repro_torch.sharding import dist

    rng = _gen(11)
    x = rng.integers(0, 64, (601, 3)).astype(np.float32)
    pts, _ = gaussian_blobs(n=120, k=4, seed=6, spread=0.3)
    s = pairwise_similarity(torch.from_numpy(pts))
    s3 = stack_levels(set_preferences(s, median_preference(s)), 2).numpy()
    return x, s3, dist.spawn(_cuda_ranks, 2, device="cuda", args=(x, s3))


def test_collectives_on_cuda_tensors_equal_the_cpu(cuda_ranks):
    """Two ranks on one card take gloo; every collective on CUDA tensors
    (through host copies) gives the CPU tensors' result, on the card."""
    for out in cuda_ranks[2]:
        assert out["transport"] == "gloo" and out["device"] == 0
        for (dev_c, c), (dev_g, g) in zip(out["cpu"], out["cuda"]):
            assert (dev_c, dev_g) == ("cpu", "cuda")
            np.testing.assert_array_equal(g, c)


def test_mr1d_stats_on_the_card_decides_as_on_the_cpu(cuda_ranks):
    _, s3, ranks = cuda_ranks
    cpu = solve(s3, backend="mr1d_stats", max_iterations=30, damping=0.6,
                device="cpu")
    for out in ranks:
        np.testing.assert_array_equal(out["solve"], cpu.exemplars)


def test_sharded_build_launches_similarity_on_each_rank(cuda_ranks):
    """Each rank's reference-scan block build runs on the similarity
    kernel (no other kernel), and the gathered lists equal the
    one-process scan on the CPU bit for bit (ROADMAP C5)."""
    x, _, ranks = cuda_ranks
    vals, idx = topk_similarity(torch.from_numpy(x), 16)
    for out in ranks:
        counts = out["launches"]
        assert counts["similarity"] > 0
        assert sum(counts.values()) == counts["similarity"]
        np.testing.assert_array_equal(out["build"][0], vals.numpy())
        np.testing.assert_array_equal(out["build"][1], idx.numpy())


# ------------------------------------------------- baselines and hooks
def test_kmeans_on_the_card_equals_the_cpu(dev):
    """K-means on the card from the same centers as the CPU: labels equal,
    centers and inertia within 1e-5 relative (cuBLAS and the CPU's BLAS
    sum the products in other orders); the seeded default init is the
    same on both."""
    from repro_torch.baselines import hierarchical_kmeans, kmeans
    from repro_torch.data import aggregation_like, gaussian_blobs

    x, _ = gaussian_blobs(n=5000, k=16, seed=0, spread=0.5)
    cpu = kmeans(x, 16, iterations=25, seed=0, device="cpu")
    card = kmeans(x, 16, iterations=25, seed=0)
    assert card.labels.device.type == "cuda"
    np.testing.assert_array_equal(card.labels.cpu().numpy(),
                                  cpu.labels.numpy())
    scale = np.abs(cpu.centers.numpy()).max()
    assert np.abs(card.centers.cpu().numpy()
                  - cpu.centers.numpy()).max() <= 1e-5 * scale
    assert abs(float(card.inertia) - float(cpu.inertia)) \
        <= 1e-5 * abs(float(cpu.inertia))
    xa, _ = aggregation_like()
    hk_card = hierarchical_kmeans(xa, levels=3, branch=3)
    hk_cpu = hierarchical_kmeans(xa, levels=3, branch=3, device="cpu")
    np.testing.assert_array_equal(hk_card.labels[-1], hk_cpu.labels[-1])


def test_curation_and_expert_clusters_on_the_card_equal_the_cpu(dev):
    from repro_torch.core.expert_affinity import cluster_experts
    from repro_torch.data.pipeline import hap_curate_batch

    rng = _gen(0)
    base = rng.standard_normal((64, 256)).astype(np.float32)
    batch = np.repeat(base, 8, axis=0) \
        + 0.02 * rng.standard_normal((512, 256)).astype(np.float32)
    np.testing.assert_array_equal(hap_curate_batch(batch),
                                  hap_curate_batch(batch, device="cpu"))
    probs = rng.random((2048, 32)).astype(np.float32) * 0.05
    hot = rng.integers(0, 16, 2048)
    probs[np.arange(2048), 2 * hot] += 0.5
    probs[np.arange(2048), 2 * hot + 1] += 0.5
    probs /= probs.sum(1, keepdims=True)
    card, cpu = cluster_experts(probs), cluster_experts(probs, device="cpu")
    np.testing.assert_array_equal(card.labels, cpu.labels)
    assert (card.labels[0::2] == card.labels[1::2]).all()


# ---------------------------------------------------- the LM serving path
class _Float32Compute:
    """The port's model modules at COMPUTE_DTYPE float32 while entered: the
    exact-arithmetic run that sizes the bfloat16 rounding."""

    def __enter__(self):
        import sys
        self.saved = [(m, m.COMPUTE_DTYPE) for name, m in
                      list(sys.modules.items())
                      if name.startswith("repro_torch.models")
                      and hasattr(m, "COMPUTE_DTYPE")]
        for m, _ in self.saved:
            m.COMPUTE_DTYPE = torch.float32

    def __exit__(self, *exc):
        for m, value in self.saved:
            m.COMPUTE_DTYPE = value


def _lm_inputs(cfg, b=2, s=24, seed=0):
    rng = _gen(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))}
    if cfg.family == "vlm":
        out["img_embeds"] = torch.from_numpy((0.02 * rng.standard_normal(
            (b, cfg.img_tokens, cfg.d_model))).astype(np.float32))
    return out


def _lm_forward(model, cfg, inputs, dev):
    from repro_torch.models import Mode, model_apply
    with torch.inference_mode():
        logits, _, _ = model_apply(
            model, cfg, {k: v.to(dev) for k, v in inputs.items()},
            Mode("train", "dense"))
    return logits.float().cpu().numpy()[..., :cfg.vocab]


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "recurrentgemma-9b",
                                  "mixtral-8x22b"])
def test_lm_decode_matches_the_full_forward_on_the_card(dev, name):
    """tests/test_models_smoke.py's property on the card (MoE at capacity
    factor 8, so that nothing is dropped)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import Mode, model_apply, model_init
    from repro_torch.models import model_state_init

    cfg = get_arch(name + "-smoke")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    model, _ = model_init(None, cfg)
    toks = _lm_inputs(cfg)["tokens"].to(dev)
    with torch.inference_mode():
        full, _, _ = model_apply(model, cfg, {"tokens": toks},
                                 Mode("train", "dense"))
        st = model_state_init(cfg, 2, 24)
        pos = torch.arange(23, device=dev)[None].expand(2, -1)
        _, st, _ = model_apply(model, cfg, {"tokens": toks[:, :-1],
                                            "positions": pos},
                               Mode("prefill", "dense"), st)
        dec, _, _ = model_apply(model, cfg, {
            "tokens": toks[:, -1:],
            "positions": torch.full((2, 1), 23, device=dev)},
            Mode("decode", "dense"), st)
    assert dec.device.type == "cuda"
    torch.testing.assert_close(dec[:, 0], full[:, -1], atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "internvl2-2b",
                                  "qwen3-moe-235b-a22b"])
def test_lm_logits_on_the_card_follow_the_cpu(dev, name, record_property):
    """The same parameters and inputs on the card and the CPU: with both
    in float32 compute, logits within 1e-4 (what the card alone could get
    wrong: TF32, another reduction order, a lost cast); as configured,
    within max(2e-2, 1.5 x the CPU's own bfloat16 error against its
    float32 run)."""
    import copy
    from repro_torch.configs import get_arch
    from repro_torch.models import model_init

    cfg = get_arch(name + "-smoke")
    model, _ = model_init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    card = copy.deepcopy(model).to(dev)
    inputs = _lm_inputs(cfg)
    got = _lm_forward(card, cfg, inputs, dev)
    want = _lm_forward(model, cfg, inputs, "cpu")
    with _Float32Compute():
        got32 = _lm_forward(card, cfg, inputs, dev)
        want32 = _lm_forward(model, cfg, inputs, "cpu")
    err32 = float(np.abs(got32 - want32).max())
    record_property("max_abs_err_f32", err32)
    np.testing.assert_allclose(got32, want32, atol=1e-4, rtol=0)
    tol = max(2e-2, 1.5 * float(np.abs(want - want32).max()))
    err = float(np.abs(got - want).max())
    record_property("max_abs_err", err)
    record_property("tolerance", tol)
    assert err <= tol


def test_continuous_batching_on_the_card_matches_isolated(dev):
    from repro_torch.configs import get_arch
    from repro_torch.models import model_init
    from repro_torch.serve import ContinuousBatchingEngine, ServeEngine

    cfg = get_arch("tinyllama-1.1b-smoke")
    model, _ = model_init(None, cfg)
    rng = _gen(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (12, 7, 12, 16, 9)]
    engine = ContinuousBatchingEngine(cfg, model, slots=2, max_len=64)
    rids = [engine.submit(p, max_new=6) for p in prompts]
    done = engine.run_to_completion()
    isolated = ServeEngine(cfg, model, max_len=64)
    for rid, p in zip(rids, prompts):
        want = isolated.generate(p[None], steps=6)
        assert want.device.type == "cuda"
        np.testing.assert_array_equal(done[rid], want.cpu().numpy()[0])


# ------------------------------------------------------ the LM training path
def _train_step(model, cfg, inputs, dev):
    import copy
    from repro_torch.models import Mode
    from repro_torch.train import make_train_step
    from repro_torch.train.loop import init_train_state

    state = init_train_state(copy.deepcopy(model).to(dev))
    state, m = make_train_step(
        cfg, Mode("train", "dense"),
        lr_kwargs={"peak": 1e-3, "warmup": 0, "total": 10})(
        state, {k: v.to(dev) for k, v in inputs.items()})
    return state, {k: float(v) for k, v in m.items()}


def _moment_gap(a, b, floor=1e-3):
    """Each leaf's largest gap relative to max(its largest |value|, floor x
    the tree's largest): a key bias's true gradient is 0, so its moments
    are rounding noise (tests/_torch_train.py)."""
    top = max(float(t.abs().max()) for t in b.values())
    return max(float((a[k].cpu() - b[k].cpu()).abs().max())
               / max(float(b[k].abs().max()), floor * top) for k in b)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen3-moe-235b-a22b"])
def test_lm_train_step_on_the_card_follows_the_cpu(dev, name,
                                                   record_property):
    """One train step from the same parameters and batch on the card and
    the CPU: with both in float32 compute, loss, ce and aux within 1e-4
    and the moments (clipped gradients and their squares) within 1e-4 of
    each leaf's scale; as configured, within max(2e-2, 1.5 x the CPU's own
    bfloat16 error against its float32 run). A second run on the card:
    the same loss, moments within 1e-4."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model_init

    cfg = get_arch(name + "-smoke")
    model, _ = model_init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    inputs = _lm_inputs(cfg)
    card, m_card = _train_step(model, cfg, inputs, dev)
    cpu, m_cpu = _train_step(model, cfg, inputs, "cpu")
    again, m_again = _train_step(model, cfg, inputs, dev)
    # a second run on the card: the backward's scatters (the embedding
    # gather's, the MoE's dispatch) may sum in another order
    record_property("rerun_bit_equal", all(
        torch.equal(again.opt.mu[k], v) for k, v in card.opt.mu.items()))
    assert m_again["loss"] == m_card["loss"]
    assert _moment_gap(again.opt.mu, card.opt.mu) <= 1e-4
    with _Float32Compute():
        card32, m_card32 = _train_step(model, cfg, inputs, dev)
        cpu32, m_cpu32 = _train_step(model, cfg, inputs, "cpu")
    assert next(card.params.parameters()).device.type == "cuda"
    assert m_card["grad_finite"] and m_card32["grad_finite"]
    for key in ("loss", "ce", "aux"):
        assert abs(m_card32[key] - m_cpu32[key]) <= 1e-4, key
        tol = max(2e-2, 1.5 * abs(m_cpu[key] - m_cpu32[key]))
        assert abs(m_card[key] - m_cpu[key]) <= tol, key
    for field in ("mu", "nu"):
        def get(s):
            return getattr(s.opt, field)
        err32 = _moment_gap(get(card32), get(cpu32))
        record_property(f"{field}_f32_err", err32)
        assert err32 <= 1e-4, field
        tol = max(2e-2, 1.5 * _moment_gap(get(cpu), get(cpu32)))
        assert _moment_gap(get(card), get(cpu)) <= tol, field


@pytest.mark.parametrize("shape,ratio,kind", [
    ((65536,), 0.01, "normal"), ((512, 300), 0.05, "ties"),
    ((2048, 64), 0.001, "normal")])
def test_topk_compress_on_the_card_equals_the_cpu(dev, shape, ratio, kind):
    """The same gradients compressed on the card and on the CPU: the
    outputs (the masks and the kept values) equal."""
    from repro_torch.runtime.compression import topk_compress

    rng = _gen(len(shape) + int(1 / ratio))
    g = (rng.standard_normal(shape) if kind == "normal"
         else rng.integers(-4, 5, shape)).astype(np.float32)
    got = topk_compress(torch.from_numpy(g).to(dev), ratio)
    assert got.device.type == "cuda"
    want = topk_compress(torch.from_numpy(g), ratio)
    assert torch.equal(got.cpu(), want)


def test_launch_train_smoke_on_the_card(dev, capsys):
    """``python -m repro_torch.launch.train --smoke``: on the card by
    default; finite losses."""
    from repro_torch.launch import train as launch_train

    assert launch_train.main(["--arch", "tinyllama-1.1b", "--smoke",
                              "--steps", "4"]) == 0
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[train] step")]
    losses = [float(line.split("loss=")[1].split()[0]) for line in lines]
    assert len(losses) == 2 and np.isfinite(losses).all()


def _moe_params(e, d=64, f=128, seed=0):
    rng = _gen(seed)
    return {"router": rng.standard_normal((d, e)).astype(np.float32) / 8,
            "gate": rng.standard_normal((e, d, f)).astype(np.float32) / 8,
            "up": rng.standard_normal((e, d, f)).astype(np.float32) / 8,
            "down": rng.standard_normal((e, f, d)).astype(np.float32) / 11}


def _moe_on(params, device):
    from repro_torch.models.layers.common import Init
    from repro_torch.models.layers.moe import MoE
    d, e = params["router"].shape
    moe = MoE(Init(None, device="meta"), d, params["gate"].shape[-1], e)
    moe = moe.to_empty(device=device)
    with torch.no_grad():
        for k, v in params.items():
            getattr(moe, k).copy_(torch.from_numpy(v))
    return moe


def _moe_run(moe, x, w):
    """y, aux and the gradients of mean(y . w) + aux."""
    from repro_torch.models.layers.moe import moe_apply
    x = x.clone().requires_grad_()
    out = moe_apply(moe, x, top_k=2, capacity_factor=8.0)
    ((out.y * w).sum() / (x.shape[0] * x.shape[1])
     + out.aux_loss).backward()
    grads = {n: p.grad.cpu() for n, p in moe.named_parameters()}
    grads["x"] = x.grad.cpu()
    return out.y.detach().cpu(), out.aux_loss.item(), grads


def _moe_card_rank(cases):
    """One rank of a (1, 2) (data, model) mesh on the card."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.partitioning import set_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((1, 2), ("data", "model"))
    out = []
    for params, x, w in cases:
        moe = _moe_on(params, "cuda")
        with set_mesh(mesh):
            out.append(_moe_run(moe, torch.from_numpy(x).cuda(),
                                torch.from_numpy(w).cuda()))
    return out


def test_sharded_moe_on_the_card_equals_the_dense_path(dev):
    """The MoE's sharded dispatch on two ranks sharing the card (gloo)
    against the dense path on the card, float32 with TF32 off, at
    ``capacity_factor=8.0`` (nothing dropped): y and aux within 1e-5, the
    gradients too (the expert weights summed over the model ranks, each
    of which uses only its block)."""
    from repro_torch.sharding import dist
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = []
    for e in (8, 3):                     # expert-parallel, ffn-parallel
        rng = _gen(e)
        cases.append((_moe_params(e),
                      rng.standard_normal((2, 64, 64)).astype(np.float32),
                      rng.standard_normal((2, 64, 64)).astype(np.float32)))
    ranks = dist.spawn(_moe_card_rank, 2, device="cuda", args=(cases,))
    for i, (params, x, w) in enumerate(cases):
        y, aux, g = _moe_run(_moe_on(params, dev), torch.from_numpy(x).to(dev),
                             torch.from_numpy(w).to(dev))
        for r in ranks:
            ry, raux, rg = r[i]
            assert (ry - y).abs().max() <= 1e-5
            assert abs(raux - aux) <= 1e-5
            for name in ("router", "x"):
                assert (rg[name] - g[name]).abs().max() <= 1e-5, name
        for name in ("gate", "up", "down"):
            got = ranks[0][i][2][name] + ranks[1][i][2][name]
            assert (got - g[name]).abs().max() <= 1e-5, name
