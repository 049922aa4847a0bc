"""The port's MR-HAP (``repro_torch.core.mrhap``) and its ``mr1d_stats``,
``mr1d_transpose`` and ``mr2d`` backends against the JAX reference, on
CPU gloo ranks (counterparts of ``tests/test_mrhap_dist.py``,
``tests/helpers/mrhap_dist_check.py`` and
``tests/helpers/solver_dist_check.py``).

One 8-rank group runs every case of this module (meshes of 1, 4 and 8
ranks, and 1 x 1, 2 x 2 and 4 x 2 grids, over the group's first ranks).
The oracle is JAX ``run_hap(order="parallel")`` on the same (L, N, N)
stack (the 160 blobs, L = 3, 25 sweeps, damping 0.6), run in this process
on one CPU device: exemplars must be equal, and r within
``R_TOL`` x max |r| (the reference's own bar; the ranks sum columns per
block and XLA contracts the damping into FMAs, ``ROADMAP.md`` C2). The
solver cases pad N = 100 to the mesh, strip the dummies and must equal
``dense_parallel``'s exemplars. The paper's driver on 4 spawned ranks
prints the reference driver's per-level lines. JAX is imported inside the
fixtures and tests: the ranks import this module, and no rank may load
JAX.
"""
import hashlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.sharding import dist  # noqa: E402

WORLD = 8
ITERS, DAMPING = 25, 0.6
R_TOL = 1e-4
MESHES = [("stats", (1,)), ("stats", (4,)), ("stats", (8,)),
          ("transpose", (1,)), ("transpose", (4,)), ("transpose", (8,)),
          ("2d", (1, 1)), ("2d", (2, 2)), ("2d", (4, 2))]
BACKENDS = ("mr1d_stats", "mr1d_transpose", "mr2d")


def _ranks(s3, s3_100, x100):
    """Every case, on one rank of the group."""
    from repro_torch.core.mrhap import run_mrhap, run_mrhap_2d
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.solver import SolveConfig, engine, solve

    s3 = torch.from_numpy(s3)
    out = {}
    for mode, shape in MESHES:
        names = ("rows", "cols") if mode == "2d" else ("workers",)
        mesh = make_mesh(shape, names)
        if not mesh.member:
            continue
        if mode == "2d":
            res = run_mrhap_2d(s3, mesh, iterations=ITERS, damping=DAMPING)
        else:
            res = run_mrhap(s3, mesh, iterations=ITERS, damping=DAMPING,
                            comm_mode=mode)
        out[(mode, shape)] = (res.exemplars.numpy(), res.n_clusters.numpy(),
                              res.r.numpy())
    for backend in BACKENDS:
        res = solve(s3_100, backend=backend, max_iterations=ITERS,
                    damping=DAMPING, device="cpu")
        out[backend] = res.exemplars
    res = solve(x100, backend="mr1d_stats", max_iterations=ITERS,
                damping=DAMPING, device="cpu")
    s = engine._build_similarity(torch.from_numpy(x100),
                                 SolveConfig(device="cpu"), "mr1d_stats")
    out["points"] = (res.exemplars,
                     hashlib.sha256(s.numpy().tobytes()).hexdigest())
    return out


@pytest.fixture(scope="module")
def stacks():
    """The oracle's inputs and outputs, from the JAX package."""
    import jax.numpy as jnp
    from repro.core import (
        pairwise_similarity, run_hap, set_preferences, stack_levels,
    )
    from repro.core.preferences import median_preference
    from repro.data import gaussian_blobs

    def stack(x):
        s = pairwise_similarity(jnp.asarray(x))
        return np.asarray(stack_levels(set_preferences(
            s, median_preference(s)), 3))

    x160, _ = gaussian_blobs(n=160, k=5, seed=3)
    x100, _ = gaussian_blobs(n=100, k=4, seed=3, spread=0.4)
    s3 = stack(x160)
    dense = run_hap(jnp.asarray(s3), iterations=ITERS, damping=DAMPING,
                    order="parallel")
    return {"s3": s3, "e": np.asarray(dense.exemplars),
            "r": np.asarray(dense.state.r), "s3_100": stack(x100),
            "x100": x100}


@pytest.fixture(scope="module")
def ranks(stacks):
    return dist.spawn(_ranks, WORLD, args=(stacks["s3"], stacks["s3_100"],
                                          stacks["x100"]))


def _assemble(ranks, mode, shape):
    """The whole r from the ranks' blocks (row blocks, or row-major tiles)."""
    key = (mode, shape)
    if mode != "2d":
        return np.concatenate([ranks[w][key][2] for w in range(shape[0])], 1)
    rows, cols = shape
    return np.concatenate([
        np.concatenate([ranks[i * cols + j][key][2] for j in range(cols)], 2)
        for i in range(rows)], 1)


@pytest.mark.parametrize("mode,shape", MESHES,
                         ids=[f"{m}-{'x'.join(map(str, s))}"
                              for m, s in MESHES])
def test_mrhap_matches_jax_parallel_hap(ranks, stacks, mode, shape):
    size = int(np.prod(shape))
    e, k, _ = ranks[0][(mode, shape)]
    np.testing.assert_array_equal(e, stacks["e"])
    for w in range(1, size):                     # every rank, the same
        np.testing.assert_array_equal(ranks[w][(mode, shape)][0], e)
    np.testing.assert_array_equal(
        k, [len(np.unique(e[l])) for l in range(e.shape[0])])
    r, r_ref = _assemble(ranks, mode, shape), stacks["r"]
    assert r.shape == r_ref.shape
    np.testing.assert_array_less(np.abs(r - r_ref).max(),
                                 R_TOL * np.abs(r_ref).max())


@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_pads_strips_and_equals_dense_parallel(ranks, stacks,
                                                     backend):
    """N = 100 on 8 ranks pads to 104 on the 1-D mesh (the 2 x 4 grid
    divides it); the result is (3, 100) with no dummy and equals
    ``dense_parallel``'s, the port's and the reference's."""
    from repro.solver import solve as j_solve
    from repro_torch.solver import solve

    ref = solve(stacks["s3_100"], backend="dense_parallel", device="cpu",
                max_iterations=ITERS, damping=DAMPING)
    j_ref = j_solve(stacks["s3_100"], backend="dense_parallel",
                    max_iterations=ITERS, damping=DAMPING)
    np.testing.assert_array_equal(ref.exemplars, j_ref.exemplars)
    for out in ranks:
        e = out[backend]
        assert e.shape == (3, 100) and e.max() < 100
        np.testing.assert_array_equal(e, ref.exemplars)


def test_every_rank_builds_the_same_similarity_from_points(ranks, stacks):
    """From points each rank builds S itself, with the same ops: the same
    bytes on every rank, and the one-process decisions."""
    from repro_torch.solver import solve

    ref = solve(stacks["x100"], backend="dense_parallel", device="cpu",
                max_iterations=ITERS, damping=DAMPING)
    digests = {out["points"][1] for out in ranks}
    assert len(digests) == 1
    for out in ranks:
        np.testing.assert_array_equal(out["points"][0], ref.exemplars)


@pytest.mark.parametrize("n,multiple", [(100, 8), (100, 4), (10, 4),
                                        (160, 64), (7, 1)])
def test_pad_similarity_equals_the_reference(n, multiple):
    import jax.numpy as jnp
    from repro.core import pad_similarity as j_pad
    from repro_torch.core import pad_similarity

    s3 = np.random.default_rng(n).standard_normal((2, n, n)).astype(
        np.float32)
    got, n0 = pad_similarity(torch.from_numpy(s3), multiple)
    want, j_n0 = j_pad(jnp.asarray(s3), multiple)
    assert n0 == j_n0 == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["stats", "transpose"])
def test_comm_model_equals_the_reference(mode):
    from repro.core import comm_bytes_per_iteration as j_comm
    from repro_torch.core import comm_bytes_per_iteration

    for n in (100, 8192, 10_609):
        for levels in (1, 3):
            for w in (1, 4, 8, 64):
                assert comm_bytes_per_iteration(n, levels, w, mode) == \
                    j_comm(n, levels, w, mode)


@pytest.mark.parametrize("backend", BACKENDS)
def test_converged_stop_is_rejected(stacks, backend):
    from repro_torch.solver import solve

    with pytest.raises(ValueError, match="does not support stop='converged'"):
        solve(stacks["s3_100"], backend=backend, stop="converged",
              device="cpu")


def test_one_rank_meshes_need_no_group(stacks):
    """Without a group the 1-D and 2-D backends run one rank with identity
    collectives and give the exemplars of the 1-rank meshes above."""
    from repro_torch.solver import solve

    for backend in BACKENDS:
        res = solve(stacks["s3"], backend=backend, max_iterations=ITERS,
                    damping=DAMPING, device="cpu")
        np.testing.assert_array_equal(res.exemplars, stacks["e"])


def test_indivisible_n_and_wrong_axes_raise(stacks):
    from repro_torch.core import run_mrhap, run_mrhap_2d
    from repro_torch.launch.mesh import make_mesh, make_worker_mesh
    from repro_torch.solver import SolveConfig, engine

    s3 = torch.zeros((2, 10, 10))
    with pytest.raises(ValueError, match="no axis"):
        run_mrhap(s3, make_mesh((1, 1), ("rows", "cols")))
    with pytest.raises(ValueError, match="no axis"):
        run_mrhap_2d(s3, make_worker_mesh())
    with pytest.raises(ValueError, match="unknown comm_mode"):
        run_mrhap(s3, make_worker_mesh(), comm_mode="shuffle")
    cfg = SolveConfig(mesh=make_worker_mesh(), pad_to=4)
    with pytest.raises(ValueError, match="2-D mesh"):
        engine.prepare_mesh("2d", cfg)
    assert engine.prepare_mesh("1d", cfg)[1] == 4


# ------------------------------------------------------------ the driver
def test_driver_on_four_ranks_matches_the_reference_driver(tmp_path,
                                                            capsys):
    """``launch.cluster --workers 4`` (spawned CPU ranks, 2-D grid, median
    preference) prints the reference driver's per-level lines, and its
    ``--ckpt`` holds the gathered (L, N, N) state and the exemplars of a
    one-process run."""
    from repro.launch import cluster as j_cluster
    from repro_torch.checkpoint import restore_tree
    from repro_torch.launch import cluster

    args = ["--dataset", "aggregation", "--preference", "median",
            "--iterations", "20"]
    assert j_cluster.main(args) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[cluster] L")]
    assert cluster.main(args + ["--workers", "4", "--device", "cpu",
                                "--parallel-mode", "2d", "--ckpt",
                                str(tmp_path / "w4")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln for ln in out if ln.startswith("[cluster] L")] == want
    assert "workers=4 transport=gloo mode=stats/2d" in out[-2]
    assert cluster.main(args + ["--device", "cpu", "--ckpt",
                                str(tmp_path / "w1")]) == 0
    like = {"r": np.zeros(1), "a": np.zeros(1), "exemplars": np.zeros(1)}
    w4 = restore_tree(str(tmp_path / "w4"), like)
    w1 = restore_tree(str(tmp_path / "w1"), like)
    assert np.asarray(w4["r"]).shape == (3, 788, 788)
    np.testing.assert_array_equal(np.asarray(w4["exemplars"]),
                                  np.asarray(w1["exemplars"]))


def test_driver_without_a_card_exits(monkeypatch):
    from repro_torch.launch import cluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cluster.main(["--workers", "2"])
