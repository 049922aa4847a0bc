"""The port's process groups and collectives (``repro_torch.sharding.dist``,
``repro_torch.launch.mesh``) and the routing under a group, on the CPU.

One 4-rank gloo group (``dist.spawn``) runs every case of this module; the
ranks' results come back through files and each test reads its own. The
collectives are held to numpy on the same blocks, with ``jax.lax``'s
``tiled=True`` semantics; ``psum`` must be bit-identical on every rank.
Routing: in a group of 4 ranks ``solve`` counts 4 devices, as the
reference counts ``jax.devices()``: N >= 64 under ``stop="fixed"`` takes
``mr1d_stats``, and ``dense_topk`` takes the sharded build and sweep from
their thresholds (lowered inside the ranks, so that a small solve crosses
them) with the one-process decisions.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.data import gaussian_blobs  # noqa: E402
from repro_torch.launch.mesh import factor_2d, make_mesh  # noqa: E402
from repro_torch.sharding import dist  # noqa: E402
from repro_torch.solver import solve  # noqa: E402

WORLD = 4


def _block(rank, shape):
    """Rank ``rank``'s distinct, exactly representable block."""
    size = int(np.prod(shape))
    return (np.arange(size, dtype=np.float32).reshape(shape) * 0.25
            + 100.0 * rank - 7.0)


def _terms(rank):
    """Rank ``rank``'s terms of a sum whose order shows in its rounding."""
    rng = np.random.default_rng(10 + rank)
    return (rng.standard_normal((3, 40)) * 10.0 ** rng.integers(
        -4, 5, (3, 40))).astype(np.float32)


def _ranks(points, dups):
    """Every case, on one rank of the group."""
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.solver import topk_build, topk_sharded

    me = dist.rank()
    out = {"rank": me, "world": dist.world_size(),
           "transport": dist.transport()}
    mesh = make_worker_mesh()
    ax = mesh.axis("workers")
    x = torch.from_numpy(_block(me, (3, 5)))
    out["index"] = dist.axis_index(ax)
    out["gather0"] = dist.all_gather(x, ax, axis=0).numpy()
    out["gather1"] = dist.all_gather(x, ax, axis=1).numpy()
    out["stack"] = dist.all_gather(x, ax, axis=1, tiled=False).numpy()
    y = torch.from_numpy(_block(me, (2, 8, 12)))
    out["a2a_1_2"] = dist.all_to_all(y, ax, split_axis=1,
                                     concat_axis=2).numpy()
    out["a2a_2_1"] = dist.all_to_all(y, ax, split_axis=2,
                                     concat_axis=1).numpy()
    z = torch.from_numpy(np.random.default_rng(me).standard_normal(
        (4, 33)).astype(np.float32))
    out["pmax"] = dist.pmax(z, ax).numpy()
    out["pmin"] = dist.pmin(z, ax).numpy()
    out["psum"] = dist.psum(z, ax).numpy()
    out["psum_int"] = dist.psum(torch.tensor([me + 1, 10]), ax).numpy()
    out["traffic"] = mesh.traffic.bytes_sent
    terms = torch.from_numpy(_terms(me))
    sent = mesh.traffic.bytes_sent

    def continue_sum(carry):
        for t in terms:                      # this rank's terms, in order
            carry = carry + t
        return carry

    out["chain"] = dist.chain_sum(continue_sum, terms[0], ax).numpy()
    out["chain_traffic"] = mesh.traffic.bytes_sent - sent

    grid = make_mesh((2, 2), ("rows", "cols"))
    for name in ("rows", "cols"):
        g = grid.axis(name)
        out[f"grid_{name}"] = (g.index, dist.all_gather(
            torch.tensor([me]), g, axis=0).numpy())
    again = make_mesh((2, 2), ("rows", "cols"))
    out["groups_reused"] = all(
        again.axis(n).group is grid.axis(n).group for n in ("rows", "cols"))
    out["traffic_apart"] = again.traffic is not grid.traffic
    sub = make_mesh((2,), ("workers",))
    out["sub_member"] = sub.member
    if sub.member:
        out["sub_gather"] = dist.all_gather(
            torch.tensor([me]), sub.axis("workers")).numpy()

    # routing: the group's 4 ranks count as 4 devices
    res = solve(points, device="cpu", max_iterations=5)
    out["route"] = (res.backend, res.exemplars)
    out["resolve"] = (
        topk_sharded.resolve_sweep("auto", n=topk_sharded.SHARDED_SWEEP_N,
                                   n_devices=dist.world_size()),
        topk_build.resolve_build_backend(
            "auto", n=topk_build.SHARDED_N, k=64,
            n_devices=dist.world_size()))
    calls = []
    run_sharded = topk_sharded.run_topk_sharded
    build_sharded = topk_build.sharded_topk_similarity

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    topk_sharded.run_topk_sharded = spy("sweep", run_sharded)
    topk_build.sharded_topk_similarity = spy("build", build_sharded)
    topk_sharded.SHARDED_SWEEP_N = topk_build.SHARDED_N = 64
    res = solve(dups, backend="dense_topk", device="cpu", k=12,
                max_iterations=20, stop="converged")
    out["topk_calls"] = calls
    out["topk"] = (res.exemplars, res.trace, res.n_sweeps, res.converged)
    return out


@pytest.fixture(scope="module")
def blobs96():
    return gaussian_blobs(n=96, k=4, seed=5, spread=0.4)[0]


@pytest.fixture(scope="module")
def dups():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 6, (130, 2)).astype(np.float32)
    x[70:] = x[:60]
    return x


@pytest.fixture(scope="module")
def ranks(blobs96, dups):
    return dist.spawn(_ranks, WORLD, args=(blobs96, dups))


def test_group_transport_and_axis_index(ranks):
    for r, out in enumerate(ranks):
        assert out["rank"] == r and out["world"] == WORLD
        assert out["transport"] == "gloo" and out["index"] == r


@pytest.mark.parametrize("case", ["gather0", "gather1", "stack"])
def test_all_gather_matches_numpy(ranks, case):
    blocks = [_block(r, (3, 5)) for r in range(WORLD)]
    want = {"gather0": np.concatenate(blocks, 0),
            "gather1": np.concatenate(blocks, 1),
            "stack": np.stack(blocks, 1)}[case]
    for out in ranks:
        np.testing.assert_array_equal(out[case], want)


@pytest.mark.parametrize("split,concat", [(1, 2), (2, 1)])
def test_all_to_all_matches_numpy(ranks, split, concat):
    """Block j of rank i along ``split`` lands on rank j, in slot i of
    ``concat`` (``lax.all_to_all(tiled=True)``)."""
    blocks = [_block(r, (2, 8, 12)) for r in range(WORLD)]
    for j, out in enumerate(ranks):
        want = np.concatenate(
            [np.split(b, WORLD, axis=split)[j] for b in blocks], axis=concat)
        np.testing.assert_array_equal(out[f"a2a_{split}_{concat}"], want)


def test_reductions_exact_and_identical_on_every_rank(ranks):
    z = np.stack([np.random.default_rng(r).standard_normal(
        (4, 33)).astype(np.float32) for r in range(WORLD)])
    acc = z[0]
    for r in range(1, WORLD):
        acc = acc + z[r]                      # rank order
    for out in ranks:
        np.testing.assert_array_equal(out["pmax"], z.max(0))
        np.testing.assert_array_equal(out["pmin"], z.min(0))
        np.testing.assert_array_equal(out["psum"], acc)
        np.testing.assert_array_equal(out["psum_int"], [10, 40])


def test_chain_sum_rounds_as_one_process(ranks):
    """Each rank continues the running sum with its terms in order, so
    the result is the sequential sum of every term in rank order, bit for
    bit, on every rank; the per-rank partials added would round
    otherwise."""
    acc = np.zeros(40, np.float32)
    partials = np.zeros(40, np.float32)
    for r in range(WORLD):
        part = np.zeros(40, np.float32)
        for t in _terms(r):
            acc = acc + t
            part = part + t
        partials = partials + part
    assert not np.array_equal(acc, partials)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["chain"], acc)
        # one hop to the next rank, or the broadcast to the other three
        assert out["chain_traffic"] == (160 if r < WORLD - 1 else 3 * 160)


def test_traffic_counts_bytes_sent_to_other_ranks(ranks):
    # 3 gathers of (3, 5) f32 to 3 ranks, 2 all-to-alls sending 3/4 of
    # (2, 8, 12) f32, 3 gathers of (4, 33) f32, one of 2 int64
    want = 3 * 3 * 60 + 2 * (768 * 3 // 4) + 3 * 3 * 528 + 3 * 16
    for out in ranks:
        assert out["traffic"] == want


def test_grid_and_sub_meshes(ranks):
    """A (2, 2) mesh lays ranks out row-major, and a second one of the same
    layout reuses its process groups (with a byte count of its own); a
    2-rank mesh in a 4-rank group holds ranks 0 and 1 only."""
    for r, out in enumerate(ranks):
        assert out["groups_reused"] and out["traffic_apart"]
        i, j = divmod(r, 2)
        assert out["grid_rows"][0] == i and out["grid_cols"][0] == j
        np.testing.assert_array_equal(out["grid_rows"][1], [j, 2 + j])
        np.testing.assert_array_equal(out["grid_cols"][1], [2 * i, 2 * i + 1])
        assert out["sub_member"] == (r < 2)
        if r < 2:
            np.testing.assert_array_equal(out["sub_gather"], [0, 1])


def test_routing_counts_the_group_ranks(ranks, blobs96):
    """In a group of 4, ``solve(x)`` with 64 <= N < 8,192 under the fixed
    stop routes to ``mr1d_stats`` (the reference's rule 4), every rank
    gets the same exemplars, and they equal ``dense_parallel``'s."""
    ref = solve(blobs96, backend="dense_parallel", device="cpu",
                max_iterations=5)
    for out in ranks:
        backend, e = out["route"]
        assert backend == "mr1d_stats"
        np.testing.assert_array_equal(e, ref.exemplars)
        assert out["resolve"] == ("sharded", "sharded")


def test_dense_topk_takes_the_sharded_build_and_sweep_in_a_group(ranks,
                                                                 dups):
    """Past the (lowered) thresholds, ``dense_topk`` in a group builds and
    sweeps sharded, with the one-process decisions."""
    ref = solve(dups, backend="dense_topk", device="cpu", k=12,
                max_iterations=20, stop="converged")
    for out in ranks:
        assert out["topk_calls"] == ["build", "sweep"]
        e, trace, n_sweeps, conv = out["topk"]
        np.testing.assert_array_equal(e, ref.exemplars)
        np.testing.assert_array_equal(trace, ref.trace)
        assert (n_sweeps, conv) == (ref.n_sweeps, ref.converged)


# ------------------------------------------------- one process, no group
def test_maybe_init_distributed_single_process_noop(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert dist.maybe_init_distributed("cpu") is False
    # an advertised single-process "group" is a no-op too
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert dist.maybe_init_distributed("cpu") is False
    assert not dist.is_initialized() and dist.world_size() == 1


def test_transport_rule(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert dist.choose_transport(cpu, 4) == "gloo"
    with pytest.raises(ValueError, match="NCCL needs a card"):
        dist.choose_transport(cpu, 2, "nccl")
    with pytest.raises(ValueError, match="unknown transport"):
        dist.choose_transport(cpu, 2, "mpi")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dist.choose_transport(cuda, 2) == "nccl"
    assert dist.choose_transport(cuda, 2, "gloo") == "gloo"
    assert dist.choose_transport(cuda, 4) == "gloo"       # ranks share
    with pytest.raises(ValueError, match="two ranks on one card"):
        dist.choose_transport(cuda, 4, "nccl")


def test_single_process_mesh_has_identity_collectives():
    mesh = make_mesh((1, 1), ("rows", "cols"))
    ax = mesh.axis("cols")
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh.member and mesh.transport == "none"
    for out in (dist.all_gather(x, ax, axis=1), dist.psum(x, ax),
                dist.pmax(x, ax), dist.all_to_all(x, ax, split_axis=0,
                                                  concat_axis=1)):
        assert out is x
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh((2, 2), ("rows", "cols"))
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis("workers")


@pytest.mark.parametrize("ranks_,want", [(1, (1, 1)), (4, (2, 2)),
                                          (6, (2, 3)), (8, (2, 4)),
                                          (7, (1, 7))])
def test_factor_2d(ranks_, want):
    assert factor_2d(ranks_) == want


def test_spawn_raises_a_rank_failure():
    with pytest.raises(Exception, match="rank 1 fails"):
        dist.spawn(_fail_on_rank_one, 2)


def _fail_on_rank_one():
    if dist.rank() == 1:
        raise RuntimeError("rank 1 fails")
    return os.getpid()
