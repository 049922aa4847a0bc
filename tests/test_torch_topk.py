"""The port's ``dense_topk`` path on the CPU against the JAX reference.

* Build: on integer-valued, duplicate-heavy points every product and sum
  is exact, so the port's reference scan, ``topk_from_dense``,
  ``topk_select_exact`` and the fused kernel's plain versions must select
  the reference's edge set exactly: ``(vals, idx)`` equal, tolerance 0,
  against ``repro.kernels.topk_similarity`` and ``topk_similarity_fused``
  (Pallas, interpret mode).
* Sweep: from one compressed stack (the reference's ``build_from_points``,
  carried over with ``convert.topk_state_from_numpy``), exemplars, trace,
  n_sweeps and converged must be equal. The float state differs because
  XLA on the CPU contracts the damping ``lam*old + (1-lam)*new`` (and the
  Eq 2.7 update) into FMAs while PyTorch rounds every operation
  (``ROADMAP.md`` queue C): r and a agree within ``STATE_RTOL`` of the
  largest |value| of the field. With the reference's FMA emulated in the
  damping, the port's state is bit-identical to the reference's.
* From points each package builds its own similarities (the same FMA
  drift in the row norms), so only final decisions are compared.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.similarity import (  # noqa: E402
    pairwise_similarity as j_pairwise,
)
from repro.data import gaussian_blobs  # noqa: E402
from repro.kernels import topk_ops as j_ops  # noqa: E402
from repro.kernels import topk_similarity as j_sim  # noqa: E402
from repro.kernels.topk_build_fused import topk_similarity_fused  # noqa: E402
from repro.solver import solve as j_solve  # noqa: E402
from repro.solver import topk as j_topk  # noqa: E402
from repro.solver import topk_sharded as j_sharded  # noqa: E402
from repro.solver import topk_build as j_topk_build  # noqa: E402
from repro.solver.topk_build import (  # noqa: E402
    resolve_build_backend as j_resolve_build,
)
from repro_torch import convert  # noqa: E402
from repro_torch.core import hap  # noqa: E402
from repro_torch.core.preferences import median_preference  # noqa: E402
from repro_torch.core.similarity import (  # noqa: E402
    pairwise_similarity, set_preferences, stack_levels,
)
from repro_torch.kernels import topk_build, topk_ops  # noqa: E402
from repro_torch.kernels import topk_similarity as p_sim  # noqa: E402
from repro_torch.solver import SolveConfig, engine, solve  # noqa: E402
from repro_torch.solver import topk, topk_sharded  # noqa: E402
from repro_torch.kernels.topk_similarity import (  # noqa: E402
    SELECT_EXACT_MAX_N,
)
from repro_torch.solver.topk_build import (  # noqa: E402
    TWOSTAGE_N, build_topk_similarity, resolve_build_backend,
)

STATE_RTOL = 5e-4   # |port - ref| of r, a over the field's largest |value|


def _dupes(n, d, seed):
    """Small integers with a run of exact duplicate points: exact
    arithmetic, many equal similarities."""
    x = np.random.default_rng(seed).integers(0, 4, (n, d)).astype(np.float32)
    x[40:60] = x[0:20]
    return x


def _same(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ------------------------------------------------------------------ build
BUILD_CASES = [  # n, d, k, block_rows, block_cols
    (130, 3, 129, 16, 32), (130, 3, 5, 16, 32), (130, 64, 129, 40, 50),
    (130, 64, 5, 40, 50), (97, 3, 9, 13, 24), (97, 64, 40, 13, 48),
]


@pytest.mark.parametrize("n,d,k,br,bc", BUILD_CASES)
def test_builds_match_reference_on_integer_points(n, d, k, br, bc):
    x = _dupes(n, d, seed=n + d + k)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want = j_sim.topk_similarity(xj, k, block_rows=br, block_cols=bc)
    _same(p_sim.topk_similarity(xt, k, block_rows=br, block_cols=bc), want)
    _same(p_sim.topk_from_dense(pairwise_similarity(xt), k),
          j_sim.topk_from_dense(j_pairwise(xj), k))
    _same(p_sim.topk_from_dense(pairwise_similarity(xt), k), want)
    fused = topk_similarity_fused(xj, k, block_rows=br, block_cols=bc)
    _same(topk_build.plain(xt, k), fused)
    _same(topk_build.in_kernel_order(xt, k), fused)
    _same(topk_build.topk_similarity_fused(xt, k), fused)   # CPU: plain
    r0 = n // 3                  # a row shard against the full column set
    _same(p_sim.topk_similarity(xt[r0:], k, block_rows=br, block_cols=bc,
                                cols=xt, row_offset=r0),
          j_sim.topk_similarity(xj[r0:], k, block_rows=br, block_cols=bc,
                                cols=xj, row_offset=r0))


@pytest.mark.parametrize("n,d,k", [(300, 3, 7), (200, 64, 40)])
def test_compare_with_plain_passes_the_kernel_order_and_fails_faults(n, d,
                                                                     k):
    """The on-card check of the kernel against ``plain``: the kernel's
    summation order (``in_kernel_order``) passes it on random floats; a
    value moved by 1 % or a column swapped in a clear row fails it."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, d)).astype(np.float32))
    vals, idx = topk_build.in_kernel_order(x, k)
    got = topk_build.compare_with_plain(x, k, vals, idx)
    assert got["values_within_tolerance"] and got["idx_equal_off_ties"]
    assert got["rows_near_tie"] < n // 10
    moved = vals.clone()
    moved[5, 0] *= 1.01
    assert not topk_build.compare_with_plain(
        x, k, moved, idx)["values_within_tolerance"]
    swapped = idx.clone()
    swapped[:, 0] = (idx[:, 0] + 1) % n
    assert not topk_build.compare_with_plain(
        x, k, vals, swapped)["idx_equal_off_ties"]


def _plain_gate(d2, thr, ties=False):
    s = -torch.clamp_min(d2, 0)
    if ties:           # a tie passes; a pair at -inf joins no list
        return (s >= thr) & (s > float("-inf"))
    return s > thr


_TINY = float(np.finfo(np.float32).smallest_subnormal)
_EDGE_D2 = [0.0, -0.0, _TINY, -_TINY, 2 * _TINY, 1.1754942e-38, -1e-7,
            -3.0, 1e-30, 0.5, 1.0, 7.25, 3.4e38, float("inf"),
            float("-inf")]
_EDGE_THR = [float("-inf"), -0.0, 0.0, -_TINY, _TINY, -2 * _TINY,
             -1.1754942e-38, -1e-30, -0.5, -1.0, -7.25, -3.4e38, 1.0]


@pytest.mark.parametrize("ties", [False, True])
def test_gate_in_kernel_on_edge_values(ties):
    """The kernel's one-compare gate equals the plain one on every pair of
    edge values: signed zeros, subnormals, negative d2 from rounding, -inf
    (an empty list) and +-inf d2. Strict (columns above the list's): d2 <
    -thr while thr < 0, nothing passes at thr = +-0. With ties (columns
    below some listed one): d2 below the float after -thr."""
    d2 = torch.tensor(_EDGE_D2, dtype=torch.float32)[:, None]
    thr = torch.tensor(_EDGE_THR, dtype=torch.float32)[None, :]
    got = topk_build.gate_in_kernel(d2, thr, ties)
    assert torch.equal(got, _plain_gate(d2, thr, ties))
    # against the neighbours of each threshold, one ulp either side
    near = torch.nextafter(-thr.expand(len(_EDGE_D2), -1),
                           torch.tensor(float("inf")))
    for probe in (near, torch.nextafter(near, torch.tensor(0.0)), -thr):
        probe = probe.expand(len(_EDGE_D2), -1)
        assert torch.equal(topk_build.gate_in_kernel(probe, thr, ties),
                           _plain_gate(probe, thr, ties))


@pytest.mark.parametrize("ties", [False, True])
def test_gate_in_kernel_on_drawn_values(ties):
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    f32 = st.floats(allow_nan=False, width=32)

    @hyp.settings(max_examples=400, deadline=None, derandomize=True)
    @hyp.given(d2=f32, thr=f32, shift=st.integers(-2, 2))
    def check(d2, thr, shift):
        t = torch.tensor([thr], dtype=torch.float32)
        # also d2 a few ulps from the bound -thr, where the two gates flip
        near = -t if thr != 0 else torch.zeros(1)
        for _ in range(abs(shift)):
            near = torch.nextafter(near, torch.tensor(
                float("inf") if shift > 0 else float("-inf")))
        for v in (torch.tensor([d2], dtype=torch.float32), near):
            assert torch.equal(topk_build.gate_in_kernel(v, t, ties),
                               _plain_gate(v, t, ties))

    check()


@pytest.mark.parametrize("n,d,k", [(130, 3, 5), (97, 64, 40), (64, 2, 63)])
def test_select_exact_matches_reference_on_shuffled_candidates(n, d, k):
    """Candidates out of column order: the explicit (value desc, col asc)
    selection picks the same slots, in the same order, as the
    reference's, and the same edge set as the dense compression."""
    x = _dupes(n, d, seed=k)
    s = np.array(j_pairwise(jnp.asarray(x)))
    np.fill_diagonal(s, -np.inf)
    perm = np.random.default_rng(k).permutation(n)
    cand_v, cand_c = s[:, perm], np.broadcast_to(perm, (n, n)).astype(np.int32)
    want = j_sim.topk_select_exact(jnp.asarray(cand_v), jnp.asarray(cand_c), k)
    got = p_sim.topk_select_exact(torch.from_numpy(cand_v),
                                  torch.from_numpy(cand_c.copy()), k)
    _same(got, want)
    _, ref_idx = j_sim.topk_from_dense(j_pairwise(jnp.asarray(x)), k)
    np.testing.assert_array_equal(np.sort(got[1].numpy(), axis=1),
                                  np.asarray(ref_idx))


@pytest.mark.parametrize("k", [0, 130])
def test_k_out_of_range_raises_reference_message(k):
    x = torch.zeros(130, 2)
    with pytest.raises(ValueError) as want:
        j_sim.topk_similarity(jnp.zeros((130, 2)), k)
    for build in (p_sim.topk_similarity, topk_build.topk_similarity_fused):
        with pytest.raises(ValueError) as got:
            build(x, k)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------- topk ops
def test_col_stats_sum_each_column_in_row_major_order():
    """The column sums equal the reference's scatter-add bit for bit on
    random floats (both add each column's edges in row-major order), and
    a float64-free sequential loop over the same order."""
    rng = np.random.default_rng(11)
    n, kk = 200, 17
    idx = np.concatenate(
        [np.arange(n)[:, None],
         np.sort(rng.integers(0, 20, (n, kk - 1)), axis=1)], 1)
    idx = idx.astype(np.int32)
    r = rng.standard_normal((3, n, kk)).astype(np.float32)
    edges = topk_ops.incoming_edges(torch.from_numpy(idx))
    col, rdiag = topk_ops.col_stats_topk(torch.from_numpy(r), edges)
    for l in range(3):
        want, want_diag = j_ops.col_stats_topk(jnp.asarray(r[l]),
                                               jnp.asarray(idx))
        np.testing.assert_array_equal(col[l].numpy(), np.asarray(want))
        np.testing.assert_array_equal(rdiag[l].numpy(), np.asarray(want_diag))
        seq = np.zeros(n, np.float32)
        rp = np.maximum(r[l], 0)
        rp[:, 0] = 0
        for i in range(n):
            for p in range(kk):
                seq[idx[i, p]] = np.float32(seq[idx[i, p]] + rp[i, p])
        np.testing.assert_array_equal(col[l].numpy(), seq)


def test_topk_ops_match_reference():
    rng = np.random.default_rng(12)
    n, kk = 150, 9
    idx = np.concatenate([np.arange(n)[:, None], np.sort(
        rng.integers(0, n, (n, kk - 1)), axis=1)], 1).astype(np.int32)
    s, a, r = (rng.integers(-4, 2, (n, kk)).astype(np.float32)
               for _ in range(3))
    c, phi, tau = (rng.integers(-3, 3, n).astype(np.float32)
                   for _ in range(3))
    T = torch.from_numpy
    J = jnp.asarray
    edges = topk_ops.incoming_edges(T(idx))
    pairs = [
        (topk_ops.rho_topk(T(s), T(a), T(tau)),
         j_ops.rho_topk(J(s), J(a), J(tau))),
        (topk_ops.alpha_topk(T(r), T(c), T(phi), T(idx), edges),
         j_ops.alpha_topk(J(r), J(c), J(phi), J(idx))),
        (topk_ops.tau_topk(T(r), T(c), edges),
         j_ops.tau_topk(J(r), J(c), J(idx))),
        (topk_ops.phi_topk(T(a), T(s)), j_ops.phi_topk(J(a), J(s))),
        (topk_ops.c_topk(T(a), T(r)), j_ops.c_topk(J(a), J(r))),
        (topk_ops.assignments_topk(T(a), T(r), T(idx)),
         j_ops.assignments_topk(J(a), J(r), J(idx))),
    ]
    for mode in ("off", "paper", "evidence"):
        pairs.append((topk_ops.s_next_topk(T(s), T(a), T(r), 0.5, mode),
                      j_ops.s_next_topk(J(s), J(a), J(r), 0.5, mode)))
    for got, want in pairs:   # integer inputs: every operation is exact
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ sweep
@pytest.fixture(scope="module")
def blobs96():
    x, _ = gaussian_blobs(n=96, k=4, seed=6, spread=0.4)
    return x


@pytest.fixture(scope="module")
def ref_stack(blobs96):
    s3k, idx = j_topk.build_from_points(jnp.asarray(blobs96), 16, 3)
    return np.asarray(s3k), np.asarray(idx)


def _port_stack(s3k, idx, levels):
    """The reference's stack carried into the port with the convert pair
    (the message fields start as the sweep's init: zeros)."""
    zeros = np.zeros_like(s3k[:levels])
    zl = np.zeros(s3k.shape[:2], np.float32)[:levels]
    st = convert.topk_state_from_numpy(
        (s3k[:levels], zeros, zeros, zl, zl, zl), idx)
    return st.hap.s, st.idx


@pytest.mark.parametrize("s_mode", ["off", "paper", "evidence"])
@pytest.mark.parametrize("stop", ["fixed", "converged"])
@pytest.mark.parametrize("levels", [1, 3])
def test_run_topk_matches_reference_on_shared_stack(levels, stop, s_mode,
                                                    ref_stack):
    s3k, idx = ref_stack
    kw = dict(max_iterations=50, damping=0.7, stop=stop, s_mode=s_mode,
              kappa=0.0 if s_mode == "off" else 0.1)
    j_state, j_e, j_n, j_conv, j_trace = j_topk.run_topk(
        jnp.asarray(s3k[:levels]), jnp.asarray(idx), **kw)
    state, e, n_sweeps, conv, trace = topk.run_topk(
        *_port_stack(s3k, idx, levels), **kw)
    assert n_sweeps == int(j_n) and bool(conv) == bool(j_conv)
    np.testing.assert_array_equal(e.numpy(), np.asarray(j_e))
    np.testing.assert_array_equal(trace[:n_sweeps],
                                  np.asarray(j_trace)[:n_sweeps])
    got = convert.topk_state_to_numpy(state)
    np.testing.assert_array_equal(got.idx, np.asarray(j_state.idx))
    for name in ("r", "a"):
        g, w = getattr(got.hap, name), np.asarray(getattr(j_state.hap, name))
        assert np.abs(g - w).max() <= STATE_RTOL * np.abs(w).max(), name


def _fma_damp(old, new, lam):
    """The reference's jitted damping on the CPU: fma(lam, old,
    round((1 - lam) * new)), one rounding (the product lam*old is exact in
    float64, and the sum rounds to float32 as one fused operation)."""
    lam32 = torch.tensor(lam, dtype=torch.float32).double()
    return (lam32 * old.double() + ((1.0 - lam) * new).double()).float()


@pytest.mark.parametrize("stop", ["fixed", "converged"])
def test_run_topk_bit_identical_with_the_references_fma(stop, monkeypatch):
    """At one level the damping's rounding is the only difference between
    the two sweeps: with the reference's FMA emulated, the whole state is
    equal. (On these 300 blobs the plain-rounded port's trace departs from
    the reference's late in the run. At three levels XLA's fusions round
    further sums differently and the emulated state still differs.)"""
    levels = 1
    x, _ = gaussian_blobs(n=300, k=4, seed=1, spread=0.4)
    s3k, idx = (np.asarray(v) for v in
                j_topk.build_from_points(jnp.asarray(x), 16, levels))
    kw = dict(max_iterations=50, damping=0.7, stop=stop)
    j_state, j_e, j_n, _, j_trace = j_topk.run_topk(
        jnp.asarray(s3k), jnp.asarray(idx), **kw)
    monkeypatch.setattr(hap, "_damp", _fma_damp)
    state, e, n_sweeps, _, trace = topk.run_topk(
        torch.from_numpy(s3k.copy()), torch.from_numpy(idx.copy()), **kw)
    np.testing.assert_array_equal(trace[:n_sweeps],
                                  np.asarray(j_trace)[:int(j_n)])
    for name, g, w in zip(state.hap._fields, state.hap, j_state.hap):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("stop", ["fixed", "converged"])
@pytest.mark.parametrize("levels", [1, 3])
def test_full_coverage_equals_dense_parallel(levels, stop, blobs96):
    x = torch.from_numpy(blobs96)
    s = pairwise_similarity(x)
    s3 = stack_levels(set_preferences(s, median_preference(s)), levels)
    sparse = solve(s3, backend="dense_topk", k=95, stop=stop, device="cpu")
    dense = solve(s3, backend="dense_parallel", stop=stop, device="cpu")
    np.testing.assert_array_equal(sparse.exemplars, dense.exemplars)
    np.testing.assert_array_equal(sparse.trace, dense.trace)
    assert sparse.n_sweeps == dense.n_sweeps
    assert sparse.converged == dense.converged


@pytest.mark.parametrize("stop", ["fixed", "converged"])
@pytest.mark.parametrize("levels", [1, 3])
def test_solve_from_points_matches_reference_decisions(levels, stop,
                                                       blobs96):
    want = j_solve(blobs96, backend="dense_topk", k=16, levels=levels,
                   stop=stop)
    got = solve(blobs96, backend="dense_topk", k=16, levels=levels,
                stop=stop, device="cpu")
    assert got.backend == "dense_topk"
    np.testing.assert_array_equal(got.exemplars, want.exemplars)
    np.testing.assert_array_equal(got.n_clusters, want.n_clusters)
    assert got.n_sweeps == want.n_sweeps and got.converged == want.converged


def test_keep_state_returns_compressed_state(blobs96):
    res = solve(blobs96, backend="dense_topk", k=16, keep_state=True,
                max_iterations=5, device="cpu")
    assert isinstance(res.state, topk.TopKState)
    assert tuple(res.state.hap.r.shape) == (3, 96, 17)
    assert torch.equal(res.state.idx[:, 0], torch.arange(96,
                                                         dtype=torch.int32))


# ----------------------------------------------------- sampled preference
@pytest.fixture(scope="module")
def blobs5000():
    x, _ = gaussian_blobs(n=5000, k=8, seed=2, spread=0.5)
    return torch.from_numpy(x)


def test_sampled_preference_is_seeded_and_near_the_exact_median(blobs5000):
    """Above PREF_EXACT_N points the median preference comes from a
    2,048-point subsample: the same seed gives the same value bit for
    bit, another seed another subsample, and the estimate lies within 3 %
    of the exact median of all 25 M off-diagonal similarities (a sample
    of 2.1 M pairs; the spread between seeds is a fraction of that)."""
    x = blobs5000
    pref = [topk.build_from_points(x, 16, 1, seed=seed)[0][0, :, 0]
            for seed in (0, 0, 1)]
    assert torch.equal(pref[0], pref[1])
    assert not torch.equal(pref[0], pref[2])
    sel = [torch.randperm(5000, generator=topk.sample_generator(s))
           [:topk.PREF_SAMPLE] for s in (0, 1)]
    assert not torch.equal(sel[0], sel[1])
    exact = float(median_preference(pairwise_similarity(x))[0])
    for p in (pref[0], pref[2]):
        assert bool((p == p[0]).all())
        assert abs(float(p[0]) - exact) <= 0.03 * abs(exact)


def test_stored_median_is_mean_of_middle_order_statistics():
    vals = torch.tensor([[-4.0, -1.0], [-3.0, -2.0]])
    assert topk.topk_preferences(vals, "median").tolist() == [-2.5, -2.5]
    want = j_topk.topk_preferences(jnp.asarray(vals.numpy()), "median")
    np.testing.assert_array_equal(
        topk.topk_preferences(vals, "median").numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(3, 1), (5, 3), (7, 5), (9, 9), (6, 4)])
@pytest.mark.parametrize("ties", [False, True])
def test_stored_median_odd_and_even_counts_match_reference(shape, ties):
    """Odd counts (the middle value twice) and even ones, with and without
    ties, as the reference's sort gives them."""
    rng = np.random.default_rng(sum(shape) + ties)
    vals = (-rng.integers(0, 4, shape) if ties
            else rng.standard_normal(shape)).astype(np.float32)
    got = topk.topk_preferences(torch.from_numpy(vals), "median")
    want = j_topk.topk_preferences(jnp.asarray(vals), "median")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- validation
@pytest.mark.parametrize("name", ["auto", "reference", "fused", "sharded",
                                  "twostage"])
def test_build_resolution_matches_reference(name):
    for n, k in ((100, 5), (8192, 64), (40_000, 64), (40_000, 20_000)):
        for metric in ("neg_sqeuclidean", "cosine"):
            for n_devices in (1, 4):
                for platform, j_platform in (("cuda", "tpu"), ("cpu", "cpu")):
                    got = resolve_build_backend(
                        name, n=n, k=k, metric=metric, n_devices=n_devices,
                        platform=platform)
                    want = j_resolve_build(
                        name, n=n, k=k, metric=metric, n_devices=n_devices,
                        platform=j_platform)
                    assert got == want


def test_auto_build_takes_twostage_where_the_reference_does():
    """A default solve off the card at N >= TWOSTAGE_N (and on the card for
    the metrics the fused kernel does not take) resolves to the two-stage
    build, as the reference's rule does; past SELECT_EXACT_MAX_N, or with
    4 k > N, to the reference scan."""
    assert TWOSTAGE_N == j_topk_build.TWOSTAGE_N
    assert SELECT_EXACT_MAX_N == j_sim.SELECT_EXACT_MAX_N
    for n in (TWOSTAGE_N, 200_000, SELECT_EXACT_MAX_N):
        assert j_resolve_build("auto", n=n, k=64, n_devices=1,
                               platform="cpu") == "twostage"
        assert resolve_build_backend("auto", n=n, k=64,
                                     platform="cpu") == "twostage"
        assert resolve_build_backend("auto", n=n, k=64,
                                     platform="cuda") == "fused"
        assert resolve_build_backend("auto", n=n, k=64, metric="cosine",
                                     platform="cuda") == "twostage"
    for n, k in ((SELECT_EXACT_MAX_N + 1, 64), (TWOSTAGE_N, 8193)):
        assert resolve_build_backend("auto", n=n, k=k,
                                     platform="cpu") == "reference"
    assert resolve_build_backend("twostage", n=TWOSTAGE_N, k=64,
                                 platform="cpu") == "twostage"


def test_sweep_and_exchange_resolution_match_reference():
    for name in topk_sharded.SWEEP_MODES:
        for n in (100, 40_000):
            for n_devices in (1, 4):
                assert topk_sharded.resolve_sweep(
                    name, n=n, n_devices=n_devices) == j_sharded.resolve_sweep(
                        name, n=n, n_devices=n_devices)
    for name in topk_sharded.EXCHANGE_MODES:
        for n, kk in ((100, 65), (300_000, 65)):
            assert topk_sharded.resolve_exchange(name, n=n, kk=kk) == \
                j_sharded.resolve_exchange(name, n=n, kk=kk)
    assert topk_sharded.SWEEP_MODES == j_sharded.SWEEP_MODES
    assert topk_sharded.EXCHANGE_MODES == j_sharded.EXCHANGE_MODES
    for bad in (topk_sharded.resolve_sweep, j_sharded.resolve_sweep):
        with pytest.raises(ValueError, match="unknown sweep mode"):
            bad("nope", n=10, n_devices=1)


def test_unported_builds_raise_and_sharded_runs_its_inner_build(blobs96):
    """Every build the knob names runs on one device or raises for a
    metric it does not take: the two-stage build (ported) and the sharded
    one (its inner build) select the reference scan's edges."""
    x = torch.from_numpy(blobs96)
    two = build_topk_similarity(x, 8, SolveConfig(build="twostage"))
    assert all(torch.equal(a, b)
               for a, b in zip(two, p_sim.topk_similarity(x, 8)))
    with pytest.raises(ValueError, match="neg_sqeuclidean' only"):
        build_topk_similarity(x, 8, SolveConfig(build="fused",
                                                metric="cosine"))
    one = build_topk_similarity(x, 8, SolveConfig(build="sharded"))
    ref = p_sim.topk_similarity(x, 8)
    assert all(torch.equal(a, b) for a, b in zip(one, ref))


def test_checkpoint_and_edge_list_input_are_not_ported(blobs96, tmp_path):
    """Pinned the refusals of a checkpointed dense_topk solve and of
    edge-list input until the graph and fault-tolerance slices ported
    them; now the checkpointed solve equals the plain one, and the
    reference's top-k edge list, handed to the port, routes to
    ``graph_affinity`` with the reference's decisions
    (``tests/test_torch_checkpoint.py`` and ``tests/test_torch_graph.py``
    hold both paths)."""
    kw = dict(backend="dense_topk", k=8, max_iterations=12, device="cpu")
    plain = solve(blobs96, **kw)
    ckpt = solve(blobs96, checkpoint_every=5, checkpoint_dir=str(tmp_path),
                 **kw)
    np.testing.assert_array_equal(ckpt.exemplars, plain.exemplars)
    np.testing.assert_array_equal(ckpt.trace, plain.trace)
    from repro.graph.edges import EdgeList as JEdgeList
    from repro_torch.graph import EdgeList
    jel = JEdgeList.from_points(blobs96, 8)
    got = solve(EdgeList(jel.src, jel.dst, jel.weight, jel.n_nodes),
                device="cpu")
    want = j_solve(jel)
    assert got.backend == want.backend == "graph_affinity"
    np.testing.assert_array_equal(got.exemplars, want.exemplars)
    np.testing.assert_array_equal(got.trace, want.trace)


# ------------------------------------------------------------- routing
def test_default_solve_routes_big_point_sets_to_dense_topk():
    """R1: N >= 8,192 points with the default config run dense_topk (it
    raised KeyError before dense_topk was registered)."""
    x, _ = gaussian_blobs(n=8192 + 5, k=8, seed=0, spread=0.5)
    res = solve(x, device="cpu", max_iterations=3)
    assert res.backend == "dense_topk"
    assert res.exemplars.shape == (3, 8197) and res.n_sweeps == 3


def test_routing_counts_one_device_on_a_multi_card_host(blobs96,
                                                        monkeypatch):
    """R2: solve() places everything on one device, so a host reporting 4
    cards routes as a one-device host (mr1d_stats is not ported)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert solve(blobs96, device="cpu", max_iterations=3).backend == \
        "dense_parallel"
    cfg = SolveConfig()
    cuda = torch.device("cuda")
    assert engine.route(96, True, cuda, cfg) == "dense_fused"
    assert engine.route(96, False, cuda, cfg) == "dense_fused"
    assert engine.route(200_000, True, cuda, cfg) == "dense_topk"
