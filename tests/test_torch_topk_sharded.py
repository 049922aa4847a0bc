"""The port's row-sharded ``dense_topk`` sweep and build
(``repro_torch.solver.topk_sharded``, ``topk_build.sharded_topk_similarity``)
on CPU gloo ranks (counterparts of ``tests/test_topk_sharded.py``,
``tests/helpers/topk_sweep_dist_check.py`` and
``tests/helpers/topk_build_dist_check.py``).

One 8-rank group runs every case (meshes over its first 1, 3, 4 or 8
ranks). The inputs are duplicate-heavy: exact duplicate points give tied
(alpha + rho) rows whose decode must break ties the same way across shard
boundaries; 150 points on 1 and 4 ranks, 1,000 on 8 (padded to a worker
multiple in both). The oracle is the port's one-process ``run_topk`` on
the same lists:

* ``exchange="allgather"`` and ``exchange="psum"``: state, exemplars,
  trace, sweep count and flag bit-exact, under both stops (the port's psum
  chains the column partials through the ranks in the one-device order;
  the reference's, which adds per-block partials, promises only the same
  exemplar sets and stop, and per-block sums do move tied decisions on
  these points);
* the decisions equal JAX ``run_topk``'s on the same lists.

The sharded build (reference-scan and two-stage inner builds, 1, 3 and 4
ranks, N = 998, a multiple of neither) gives the one-process edge sets.
JAX is imported inside the tests: the ranks import this module.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.sharding import dist  # noqa: E402
from repro_torch.solver import SolveConfig  # noqa: E402
from repro_torch.solver.topk import build_from_points, run_topk  # noqa: E402

WORLD = 8
STATE = ("s", "r", "a", "tau", "phi", "c")
# (points, workers): 150 duplicate-heavy points, and 1,000 of them on 8
SWEEPS = [("dup150", 1), ("dup150", 4), ("dup1000", 8), ("blobs150", 4)]
STOPS = ("fixed", "converged")
EXCHANGES = ("allgather", "psum")
BUILDS = [(inner, w) for inner in ("reference", "twostage")
          for w in (1, 3, 4)]
N_BUILD, K_BUILD = 998, 24


def dup_points(n, d, seed):
    """A few tight centers plus many exact duplicates of them."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((d + 2, d)).astype(np.float32) * 4.0
    x = centers[rng.integers(0, d + 2, n)]
    x[: n // 2] += 0.05 * rng.standard_normal((n // 2, d)).astype(np.float32)
    return x


def _lists():
    """Compressed stacks of each input (the port's build, on the CPU)."""
    from repro_torch.data import gaussian_blobs

    out = {}
    for name, x, k, levels, iters in (
            ("dup150", dup_points(150, 2, 3), 12, 3, 25),
            ("dup1000", dup_points(1000, 3, 4), 24, 3, 40),
            ("blobs150", gaussian_blobs(n=150, k=4, seed=2)[0], 12, 3, 25)):
        s3k, idx = build_from_points(torch.from_numpy(x), k, levels)
        out[name] = (s3k.numpy(), idx.numpy(), iters, x)
    return out


def _ranks(lists, xb):
    """Every case, on one rank of the group."""
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.solver import solve
    from repro_torch.solver.topk_build import sharded_topk_similarity
    from repro_torch.solver.topk_sharded import gather_state, run_topk_sharded

    out = {}
    for name, w in SWEEPS:
        s3k, idx, iters, _ = lists[name]
        mesh = make_worker_mesh(w)
        if not mesh.member:
            continue
        for stop in STOPS:
            for exchange in EXCHANGES:
                st, e, ns, conv, tr = run_topk_sharded(
                    torch.from_numpy(s3k), torch.from_numpy(idx), mesh,
                    max_iterations=iters, damping=0.7, stop=stop,
                    patience=5, exchange=exchange)
                full = gather_state(st, mesh)
                out[(name, w, stop, exchange)] = (
                    e.numpy(), ns, conv, tr,
                    [t.numpy() for t in full.hap] if dist.rank() == 0
                    else None)
    cfg = SolveConfig(device="cpu")
    for inner, w in BUILDS:
        mesh = make_worker_mesh(w)
        if mesh.member:
            v, i = sharded_topk_similarity(torch.from_numpy(xb), K_BUILD, cfg,
                                           mesh=mesh, inner=inner)
            out[(inner, w)] = (v.numpy(), i.numpy())
    x = lists["dup1000"][3]
    res = solve(x, backend="dense_topk", k=24, levels=2, max_iterations=25,
                stop="converged", sweep="sharded", build="sharded",
                exchange="allgather", device="cpu")
    out["solve"] = (res.exemplars, res.trace, res.n_sweeps, res.converged)
    return out


@pytest.fixture(scope="module")
def lists():
    return _lists()


@pytest.fixture(scope="module")
def build_points():
    return dup_points(N_BUILD, 3, 7)


@pytest.fixture(scope="module")
def ranks(lists, build_points):
    return dist.spawn(_ranks, WORLD, args=(lists, build_points))


@pytest.fixture(scope="module")
def oracle(lists):
    out = {}
    for name, (s3k, idx, iters, _) in lists.items():
        for stop in STOPS:
            out[(name, stop)] = run_topk(
                torch.from_numpy(s3k), torch.from_numpy(idx),
                max_iterations=iters, damping=0.7, stop=stop, patience=5)
    return out


def _case_ids(cases):
    return ["-".join(map(str, c)) for c in cases]


ALLGATHER = [(n, w, s) for n, w in SWEEPS for s in STOPS]


def _bit_exact(ranks, oracle, name, w, stop, exchange):
    st, e, ns, conv, tr = oracle[(name, stop)]
    n = e.shape[1]
    for r in range(w):
        e2, ns2, conv2, tr2, state = ranks[r][(name, w, stop, exchange)]
        np.testing.assert_array_equal(e2[:, :n], e.numpy())
        assert e2.shape[1] == -(-n // w) * w          # padded, then stripped
        np.testing.assert_array_equal(tr2, tr)
        assert (ns2, conv2) == (ns, conv)
    for f, got in zip(STATE, ranks[0][(name, w, stop, exchange)][4]):
        np.testing.assert_array_equal(got[:, :n],
                                      getattr(st.hap, f).numpy(), err_msg=f)


@pytest.mark.parametrize("name,w,stop", ALLGATHER, ids=_case_ids(ALLGATHER))
def test_allgather_is_bit_exact_against_run_topk(ranks, oracle, name, w,
                                                 stop):
    _bit_exact(ranks, oracle, name, w, stop, "allgather")


@pytest.mark.parametrize("name,w,stop", ALLGATHER, ids=_case_ids(ALLGATHER))
def test_psum_keeps_the_decisions(ranks, oracle, name, w, stop):
    """The chained psum exchange is bit-exact too, so every decision (and
    the reference's weaker contract, the exemplar sets) holds."""
    _bit_exact(ranks, oracle, name, w, stop, "psum")


@pytest.mark.parametrize("name,w,stop", ALLGATHER, ids=_case_ids(ALLGATHER))
def test_decisions_equal_jax_run_topk(ranks, lists, name, w, stop):
    """From the same lists, the sharded sweep's exemplars, trace, sweep
    count and flag equal the JAX reference's one-device ``run_topk``."""
    import jax.numpy as jnp
    from repro.solver.topk import run_topk as j_run_topk

    s3k, idx, iters, _ = lists[name]
    _, e, ns, conv, tr = j_run_topk(
        jnp.asarray(s3k), jnp.asarray(idx), max_iterations=iters,
        damping=0.7, stop=stop, patience=5)
    n = s3k.shape[1]
    e2, ns2, conv2, tr2, _ = ranks[0][(name, w, stop, "allgather")]
    np.testing.assert_array_equal(e2[:, :n], np.asarray(e))
    np.testing.assert_array_equal(tr2, np.asarray(tr))
    assert ns2 == int(ns) and conv2 == bool(conv)


@pytest.mark.parametrize("inner,w", BUILDS, ids=_case_ids(BUILDS))
def test_sharded_build_equals_the_one_process_build(ranks, build_points,
                                                    inner, w):
    from repro_torch.solver.topk_build import _local_build

    v, i = _local_build(torch.from_numpy(build_points), K_BUILD,
                        SolveConfig(device="cpu"), inner)
    for r in range(w):
        got_v, got_i = ranks[r][(inner, w)]
        np.testing.assert_array_equal(got_v, v.numpy())
        np.testing.assert_array_equal(got_i, i.numpy())


def test_solve_sharded_equals_single_end_to_end(ranks, lists):
    """``solve(x, sweep="sharded", build="sharded")`` on 8 ranks equals the
    one-process ``sweep="single"`` solve with the reference-scan build."""
    from repro_torch.solver import solve

    ref = solve(lists["dup1000"][3], backend="dense_topk", k=24, levels=2,
                max_iterations=25, stop="converged", sweep="single",
                build="reference", device="cpu")
    for out in ranks:
        e, trace, ns, conv = out["solve"]
        np.testing.assert_array_equal(e, ref.exemplars)
        np.testing.assert_array_equal(trace, ref.trace)
        assert (ns, conv) == (ref.n_sweeps, ref.converged)


def test_one_rank_sharded_solve_takes_the_one_device_loop(lists):
    """Without a group ``sweep="sharded"`` detours to the one-device loop,
    as the reference does on a one-worker mesh."""
    from repro_torch.solver import solve

    x = lists["dup150"][3]
    kw = dict(backend="dense_topk", k=16, levels=2, max_iterations=20,
              stop="converged", device="cpu")
    ref, res = solve(x, sweep="single", **kw), solve(x, sweep="sharded", **kw)
    np.testing.assert_array_equal(res.exemplars, ref.exemplars)
    assert (res.n_sweeps, res.converged) == (ref.n_sweeps, ref.converged)


@pytest.mark.parametrize("n,multiple", [(100, 8), (100, 4), (5, 3)])
def test_pad_topk_equals_the_reference(n, multiple):
    import jax.numpy as jnp
    from repro.solver.topk_sharded import pad_topk as j_pad_topk
    from repro_torch.solver.topk_sharded import pad_topk

    rng = np.random.default_rng(n)
    s3k = rng.standard_normal((2, n, 4)).astype(np.float32)
    idx = rng.integers(0, n, (n, 4)).astype(np.int32)
    t_s3k, t_idx = torch.from_numpy(s3k), torch.from_numpy(idx)
    got = pad_topk(t_s3k, t_idx, multiple)
    want = j_pad_topk(jnp.asarray(s3k), jnp.asarray(idx), multiple)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == want[2] == n
    if n % multiple == 0:                      # strict passthrough
        assert got[0] is t_s3k and got[1] is t_idx


@pytest.mark.parametrize("exchange", ["allgather", "psum"])
def test_comm_model_equals_the_reference(exchange):
    from repro.solver.topk_sharded import comm_bytes_per_sweep as j_comm
    from repro_torch.solver.topk_sharded import comm_bytes_per_sweep

    for n in (1000, 200_000, 10 ** 6):
        for k in (24, 64):
            for levels in (1, 3):
                for w in (1, 4, 8):
                    assert comm_bytes_per_sweep(n, k, levels, w, exchange) \
                        == j_comm(n, k, levels, w, exchange)


def test_non_worker_mesh_is_rejected(lists):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.solver.topk_sharded import run_topk_sharded

    s3k, idx, _, _ = lists["dup150"]
    with pytest.raises(ValueError, match="1-D mesh"):
        run_topk_sharded(torch.from_numpy(s3k), torch.from_numpy(idx),
                         make_mesh((1, 1), ("rows", "cols")),
                         max_iterations=3)
