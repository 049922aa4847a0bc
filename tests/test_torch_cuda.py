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
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import (  # noqa: E402
    availability, launch_counts, reset_launch_counts, responsibility,
    similarity, topk_build, topk_ops,
)
from repro_torch.kernels.topk_similarity import topk_similarity  # noqa: E402
from repro_torch.solver import solve  # noqa: E402

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
                      "availability": 3 * 20, "topk_build": 0}
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
    (1001, 3, 64), (700, 5, 699), (1500, 2, 650), (4099, 64, 129)])
@pytest.mark.parametrize("kind", ["random", "integer", "duplicate"])
def test_topk_build_kernel_bit_identical(dev, n, d, k, kind):
    """k = N - 1, ragged N against the 32-row blocks, and k past the
    shared-memory lists (640) included."""
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
                      "availability": 0, "topk_build": 1}
    ref = solve(x, max_iterations=20, build="reference")
    np.testing.assert_array_equal(fused.exemplars, ref.exemplars)
    np.testing.assert_array_equal(fused.trace, ref.trace)
