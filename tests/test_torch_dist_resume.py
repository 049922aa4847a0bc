"""The rest of the port's distributed path on CPU gloo ranks: the sharded
Borůvka (``graph.affinity.run_graph_affinity(mesh=...)``, the
``graph_affinity`` backend in a group) and checkpointed sharded sweeps
(``solver.checkpointing`` with a mesh) — counterparts of
``tests/test_graph.py``'s sharded cases (``tests/helpers/graph_dist_check.py``)
and of ``test_checkpoint_resume.py::test_sharded_crash_resume_bit_exact``
(``tests/helpers/resume_parity_check.py``).

One 4-rank group runs every case, with meshes over its first 1, 3 and 4
ranks; N is a multiple of neither 3 nor 4, so every sharded run pads.

* Borůvka on the duplicate-heavy graphs of ``tests/test_graph.py`` (weights
  from a 3-value set, so nearly every selection is a tie) and on a graph
  with components and an isolated node: labels, rounds, flag and trace
  bit-equal to the port's one-process loop on every rank, and equal to
  JAX's ``run_graph_affinity``.
* Checkpointed sharded sweeps under both exchanges and both stops,
  uninterrupted, and crashed at the second save then resumed: exemplars,
  trace, sweep count, flag and the real rows of the state bit-equal to the
  plain sharded run; decisions equal to JAX's ``run_topk``.
* The directories cross between the packages: a one-worker
  ``"dense_topk_sharded"`` run written by JAX resumes in the port's
  one-rank mesh, and the port writes the same meta, key paths, shapes and
  dtypes.

JAX is imported inside the tests: the ranks import this module.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.graph import EdgeList  # noqa: E402
from repro_torch.sharding import dist  # noqa: E402
from repro_torch.solver import SolveConfig  # noqa: E402
from repro_torch.solver.topk import build_from_points  # noqa: E402

WORLD = 4
STATE = ("s", "r", "a", "tau", "phi", "c")
GRAPHS = ("dup_heavy", "dup_heavy_wide", "components")
MESHES = (1, 3, 4)
STOPS = ("fixed", "converged")
EXCHANGES = ("allgather", "psum")
# (exchange, stop, workers) of the checkpointed runs
CKPT = [(x, s, 4) for x in EXCHANGES for s in STOPS] + [("psum", "fixed", 3)]
N_PTS, K, LEVELS, ITERS, EVERY = 150, 12, 3, 40, 4


def duplicate_heavy_graph(n=120, seed=3, weights=(1.0, 2.0, 3.0)):
    """``tests/test_graph.py``'s graph (copied): random symmetric edges
    whose weights come from a 3-value set."""
    rng = np.random.default_rng(seed)
    m = 6 * n
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.choice(np.asarray(weights, np.float32), m)
    return EdgeList(src, dst, w).canonical()


def _graphs():
    """name -> (canonical edge list, to_topk layout); node counts are
    multiples of neither 3 nor 4."""
    els = {
        "dup_heavy": duplicate_heavy_graph(n=121, seed=3),
        "dup_heavy_wide": duplicate_heavy_graph(n=301, seed=11,
                                                weights=(1.0, 2.0)),
        # two 2-cliques, a triangle and three isolated nodes
        "components": EdgeList(
            np.asarray([0, 1, 2, 3, 4, 5, 6], np.int32),
            np.asarray([1, 0, 3, 2, 5, 6, 4], np.int32),
            np.ones(7, np.float32), n_nodes=10).canonical(),
    }
    for el in els.values():
        assert el.n_nodes % 3 and el.n_nodes % 4
    return {name: (el, el.to_topk()) for name, el in els.items()}


def _lists():
    """The compressed stack every checkpointed case runs on (the port's
    build on the CPU), as numpy arrays."""
    from repro_torch.data import gaussian_blobs

    x, _ = gaussian_blobs(n=N_PTS, k=4, seed=2)
    s3k, idx = build_from_points(torch.from_numpy(x), K, LEVELS)
    return s3k.numpy(), idx.numpy(), x


def _cfg(stop, exchange, **kw):
    return SolveConfig(k=K, levels=LEVELS, stop=stop, max_iterations=ITERS,
                       patience=5, damping=0.7, exchange=exchange,
                       device="cpu", **kw)


def _full(state, mesh):
    """The gathered padded state as numpy arrays (every rank gathers)."""
    from repro_torch.solver.topk_sharded import gather_state
    return [t.numpy() for t in gather_state(state, mesh).hap]


def _ranks(tmp, graphs, lists):
    """Every case, on one rank of the group."""
    from repro_torch.graph import affinity
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.runtime import faultinject
    from repro_torch.solver import checkpointing, solve, topk_sharded

    out = {}
    for w in MESHES:
        mesh = make_worker_mesh(w)
        if not mesh.member:
            continue
        for name, (_, (vals, idx)) in graphs.items():
            hist, r, conv, trace = affinity.run_graph_affinity(
                vals, idx, levels=3, mesh=mesh)
            out[("graph", name, w)] = (hist.numpy(), r, conv, trace[:r])

    from repro_torch.launch.mesh import make_mesh
    grid = make_mesh((WORLD, 1), ("workers", "cols"))
    try:
        affinity.run_graph_affinity(*graphs["dup_heavy"][1], mesh=grid)
        out["grid_refused"] = None
    except ValueError as err:
        out["grid_refused"] = str(err)

    # solve(edge_list) in the group: which mesh reaches the round loop
    seen = []
    run = affinity.run_graph_affinity

    def recording(*a, mesh=None, **kw):
        seen.append(None if mesh is None else mesh.shape["workers"])
        return run(*a, mesh=mesh, **kw)

    affinity.run_graph_affinity = recording
    el = graphs["dup_heavy_wide"][0]
    try:
        res = {sweep: solve(el, backend="graph_affinity", levels=3,
                            sweep=sweep, device="cpu")
               for sweep in ("auto", "sharded")}
        # the default (auto) routing takes the mesh from SHARDED_SWEEP_N
        floor = topk_sharded.SHARDED_SWEEP_N
        topk_sharded.SHARDED_SWEEP_N = el.n_nodes
        try:
            res["auto, N above the threshold"] = solve(el, levels=3,
                                                       device="cpu")
        finally:
            topk_sharded.SHARDED_SWEEP_N = floor
    finally:
        affinity.run_graph_affinity = run
    out["solve_graph"] = ({k: (r.exemplars, r.trace, r.n_sweeps, r.backend)
                           for k, r in res.items()}, seen)

    s3k, idx, x = (torch.from_numpy(a) for a in lists)
    for exchange, stop, w in CKPT:
        mesh = make_worker_mesh(w)
        if not mesh.member:
            continue
        d = os.path.join(tmp, f"{exchange}_{stop}_{w}")
        cfg = _cfg(stop, exchange, checkpoint_every=EVERY, checkpoint_dir=d)
        runs = {"plain": topk_sharded.run_topk_sharded(
            s3k, idx, mesh, max_iterations=ITERS, damping=0.7, stop=stop,
            patience=5, exchange=exchange)}
        runs["checkpointed"] = checkpointing.run_topk_checkpointed(
            s3k, idx, cfg, mesh=mesh)
        steps = sorted(os.listdir(d))
        inj = faultinject.FaultInjector().add(
            faultinject.Rule("solver.sweep", nth=1, match={"kind": "sharded"}))
        try:
            with faultinject.active(inj):
                checkpointing.run_topk_checkpointed(s3k, idx, cfg, mesh=mesh)
            crashed = False
        except faultinject.InjectedFault:
            crashed = True
        crash_steps = sorted(os.listdir(d))
        resumed = faultinject.FaultInjector()
        with faultinject.active(resumed):
            runs["resumed"] = checkpointing.run_topk_checkpointed(
                s3k, idx, cfg.replace(resume_from=d), mesh=mesh)
        out[("ckpt", exchange, stop, w)] = {
            "crashed": crashed, "fresh_hits": inj.hits("solver.sweep"),
            "resume_hits": resumed.hits("solver.sweep"),
            "steps": steps, "crash_steps": crash_steps,
            **{k: (e.numpy(), int(ns), bool(conv), np.asarray(tr),
                   _full(st, mesh))
               for k, (st, e, ns, conv, tr) in runs.items()}}

    # a checkpointed default solve in the group takes the sharded runner
    d = os.path.join(tmp, "solve")
    floor = topk_sharded.SHARDED_SWEEP_N
    topk_sharded.SHARDED_SWEEP_N = N_PTS
    try:
        res = solve(lists[2], backend="dense_topk", k=K, levels=LEVELS,
                    max_iterations=ITERS, preference="median",
                    checkpoint_every=EVERY, checkpoint_dir=d, device="cpu")
    finally:
        topk_sharded.SHARDED_SWEEP_N = floor
    with open(os.path.join(d, "solve_meta.json")) as f:
        meta = json.load(f)
    out["solve_ckpt"] = (res.exemplars, res.trace, res.n_sweeps, meta)
    return out


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


@pytest.fixture(scope="module")
def lists():
    return _lists()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, graphs, lists):
    tmp = str(tmp_path_factory.mktemp("dist_resume"))
    return dist.spawn(_ranks, WORLD, args=(tmp, graphs, lists))


def _ids(cases):
    return ["-".join(map(str, c)) for c in cases]


GRAPH_CASES = [(g, w) for g in GRAPHS for w in MESHES]


@pytest.mark.parametrize("name,w", GRAPH_CASES, ids=_ids(GRAPH_CASES))
def test_sharded_boruvka_is_bit_exact(ranks, graphs, name, w):
    """Every rank's labels, rounds, flag and trace equal the one-process
    loop's; the label stack comes back in the padded N'."""
    from repro_torch.graph import affinity

    el, (vals, idx) = graphs[name]
    n = el.n_nodes
    hist, r, conv, trace = affinity.run_graph_affinity(vals, idx, levels=3)
    for k in range(w):
        got, r2, conv2, trace2 = ranks[k][("graph", name, w)]
        assert got.shape == (3, -(-n // w) * w)
        np.testing.assert_array_equal(got[:, :n], hist.numpy())
        # the padding stays singletons
        np.testing.assert_array_equal(got[:, n:],
                                      np.tile(np.arange(n, got.shape[1]),
                                              (3, 1)))
        assert (r2, conv2) == (r, conv)
        np.testing.assert_array_equal(trace2, trace[:r])


@pytest.mark.parametrize("name", GRAPHS)
def test_sharded_boruvka_equals_jax(ranks, graphs, name):
    from repro.graph.affinity import run_graph_affinity as j_run

    el, (vals, idx) = graphs[name]
    hist, r, conv, trace = j_run(vals, idx, levels=3)
    got, r2, conv2, trace2 = ranks[0][("graph", name, 4)]
    np.testing.assert_array_equal(got[:, :el.n_nodes], np.asarray(hist))
    assert (r2, conv2) == (int(r), bool(conv))
    np.testing.assert_array_equal(trace2, np.asarray(trace)[:int(r)])


def test_sharded_boruvka_refuses_a_mesh_of_other_axes(ranks):
    for out in ranks:
        assert "1-D mesh with axis 'workers'" in out["grid_refused"]


def test_solve_edge_list_in_a_group_takes_the_mesh(ranks, graphs):
    """In the group, ``solve(edge_list)`` hands the round loop a 4-rank mesh
    under ``sweep="sharded"`` and, past ``SHARDED_SWEEP_N``, under the
    default; below it the default keeps the one-device loop. Every result
    equals the one-process solve."""
    from repro_torch.solver import solve

    el = graphs["dup_heavy_wide"][0]
    ref = solve(el, backend="graph_affinity", levels=3, device="cpu")
    for out in ranks:
        res, seen = out["solve_graph"]
        assert seen == [None, 4, 4]
        for e, trace, ns, backend in res.values():
            assert backend == "graph_affinity"
            np.testing.assert_array_equal(e, ref.exemplars)
            np.testing.assert_array_equal(trace, ref.trace)
            assert ns == ref.n_sweeps


def _equal_runs(got, want, n, state_rows):
    e, ns, conv, tr, st = got
    e0, ns0, conv0, tr0, st0 = want
    np.testing.assert_array_equal(e[:, :n], e0[:, :n])
    np.testing.assert_array_equal(tr, tr0)
    assert (ns, conv) == (ns0, conv0)
    for f, a, b in zip(STATE, st, st0):
        np.testing.assert_array_equal(a[:, :state_rows], b[:, :state_rows],
                                      err_msg=f)


@pytest.mark.parametrize("exchange,stop,w", CKPT, ids=_ids(CKPT))
def test_checkpointed_sharded_sweeps_resume_bit_exact(ranks, exchange, stop,
                                                      w):
    """Uninterrupted checkpointed and crashed-then-resumed runs equal the
    plain sharded run on every rank: the whole padded state for the
    former, the real rows for the latter (a resume restarts the dummies at
    their initial values). The crash left the directory of its two saves,
    and the resume fired fewer segment boundaries than a whole run."""
    for k in range(w):
        got = ranks[k][("ckpt", exchange, stop, w)]
        plain = got["plain"]
        n_total = plain[0].shape[1]
        _equal_runs(got["checkpointed"], plain, N_PTS, n_total)
        _equal_runs(got["resumed"], plain, N_PTS, N_PTS)
        assert got["crashed"]
        assert got["crash_steps"] == ["solve_meta.json", "step_0000000004",
                                      "step_0000000008"]
        ns = plain[1]
        segments = -(-ns // EVERY)
        assert got["steps"][-1] == f"step_{ns:010d}"
        assert got["fresh_hits"] == 2
        assert 0 < got["resume_hits"] == segments - 2


@pytest.mark.parametrize("exchange,stop,w", CKPT, ids=_ids(CKPT))
def test_checkpointed_sharded_decisions_equal_jax(ranks, lists, exchange,
                                                  stop, w):
    import jax.numpy as jnp
    from repro.solver.topk import run_topk as j_run_topk

    s3k, idx, _ = lists
    _, e, ns, conv, tr = j_run_topk(
        jnp.asarray(s3k), jnp.asarray(idx), max_iterations=ITERS,
        damping=0.7, stop=stop, patience=5)
    got = ranks[0][("ckpt", exchange, stop, w)]["resumed"]
    np.testing.assert_array_equal(got[0][:, :N_PTS], np.asarray(e))
    np.testing.assert_array_equal(got[3], np.asarray(tr))
    assert (got[1], got[2]) == (int(ns), bool(conv))


def test_checkpointed_default_solve_in_a_group(ranks, lists):
    """A checkpointed ``dense_topk`` solve in the group no longer raises:
    it takes the sharded runner (its meta says so) and equals the
    one-process solve."""
    from repro_torch.solver import solve

    ref = solve(lists[2], backend="dense_topk", k=K, levels=LEVELS,
                max_iterations=ITERS, preference="median", device="cpu")
    for out in ranks:
        e, trace, ns, meta = out["solve_ckpt"]
        assert meta["kind"] == "dense_topk_sharded" and meta["workers"] == 4
        np.testing.assert_array_equal(e, ref.exemplars)
        np.testing.assert_array_equal(trace, ref.trace)
        assert ns == ref.n_sweeps


@pytest.mark.parametrize("stop", STOPS)
def test_one_rank_mesh_matches_the_reference_directory(tmp_path, lists,
                                                       stop):
    """JAX's ``run_topk_checkpointed(mesh=make_worker_mesh())`` on its one
    CPU device writes a ``"dense_topk_sharded"`` directory and crashes at
    its second save; the port resumes it in a one-rank mesh to JAX's
    uninterrupted decisions. The port's own directory of the same run has
    the reference's meta and the same key paths, shapes and dtypes."""
    import jax.numpy as jnp
    from repro.launch.mesh import make_worker_mesh as j_mesh
    from repro.runtime import faultinject as j_fi
    from repro.solver import SolveConfig as JConfig
    from repro.solver import checkpointing as j_ckp
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.solver import checkpointing

    s3k, idx, _ = lists
    js3k, jidx = jnp.asarray(s3k), jnp.asarray(idx)
    kw = dict(k=K, levels=LEVELS, stop=stop, max_iterations=ITERS,
              patience=5, damping=0.7, exchange="allgather",
              checkpoint_every=EVERY)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    _, e, ns, conv, tr = j_ckp.run_topk_checkpointed(
        js3k, jidx, JConfig(**kw, checkpoint_dir=str(tmp_path / "whole")),
        mesh=j_mesh())
    inj = j_fi.FaultInjector().add(j_fi.Rule("solver.sweep", nth=1))
    with j_fi.active(inj), pytest.raises(j_fi.InjectedFault):
        j_ckp.run_topk_checkpointed(js3k, jidx,
                                    JConfig(**kw, checkpoint_dir=d_ref),
                                    mesh=j_mesh())
    mesh = make_worker_mesh(1)
    t_s3k, t_idx = torch.from_numpy(s3k), torch.from_numpy(idx)
    got = checkpointing.run_topk_checkpointed(
        t_s3k, t_idx, _cfg(stop, "allgather", resume_from=d_ref), mesh=mesh)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(e))
    np.testing.assert_array_equal(got[4], np.asarray(tr))
    assert (got[2], got[3]) == (int(ns), bool(conv))

    from repro_torch.runtime import faultinject

    inj = faultinject.FaultInjector().add(
        faultinject.Rule("solver.sweep", nth=1))
    with faultinject.active(inj), pytest.raises(faultinject.InjectedFault):
        checkpointing.run_topk_checkpointed(
            t_s3k, t_idx, _cfg(stop, "allgather", checkpoint_every=EVERY,
                               checkpoint_dir=d_port), mesh=mesh)

    def read(d, name):
        with open(os.path.join(d, name)) as f:
            return json.load(f)

    assert read(d_port, "solve_meta.json") == read(d_ref, "solve_meta.json")
    assert sorted(os.listdir(d_port)) == sorted(os.listdir(d_ref))
    for step in (EVERY, 2 * EVERY):
        step = f"step_{step:010d}"
        m_ref, m_port = (read(os.path.join(d, step), "manifest.json")
                         for d in (d_ref, d_port))
        assert m_port == m_ref                 # key paths, dtypes, shapes
        with np.load(os.path.join(d_ref, step, "arrays.npz")) as a_ref, \
                np.load(os.path.join(d_port, step, "arrays.npz")) as a_port:
            assert sorted(a_port.files) == sorted(a_ref.files)
            for f in a_ref.files:
                assert (a_port[f].shape, a_port[f].dtype) == \
                    (a_ref[f].shape, a_ref[f].dtype), f


def test_repad_carry_restores_the_real_rows(lists):
    """``_repad_carry`` on a block that straddles the padding: real rows
    from the saved tree, dummies at ``hap_init`` and pointing at
    themselves."""
    from repro_torch.core import hap
    from repro_torch.solver import checkpointing
    from repro_torch.solver.topk_sharded import ShardedSweep, pad_topk

    s3k, idx, _ = (torch.from_numpy(a) for a in lists)
    s_p, idx_p, n = pad_topk(s3k, idx, 4)
    b = s_p.shape[1] // 4
    rng = np.random.default_rng(0)
    tree = {f: rng.standard_normal(
        (LEVELS, n, K + 1) if f in ("s", "r", "a") else (LEVELS, n)
    ).astype(np.float32) for f in STATE}
    tree.update(e_prev=rng.integers(0, n, (LEVELS, n)).astype(np.int32),
                stable=np.int32(2), it=np.int32(8),
                trace=np.arange(ITERS, dtype=np.int32))
    run = ShardedSweep(dist.Axis("workers", 4, 3, None, (0, 1, 2, 3), "none",
                                 dist.Traffic()),
                       s_p[:, 3 * b:], idx_p[3 * b:], n, "allgather", None,
                       None, None)
    state, e, stable, it, trace = checkpointing._repad_carry(tree, run)
    m = n - 3 * b
    init = hap.hap_init(s_p[:, 3 * b:])
    for f, got, fresh in zip(STATE, state, init):
        np.testing.assert_array_equal(got[:, :m].numpy(),
                                      tree[f][:, 3 * b:], err_msg=f)
        np.testing.assert_array_equal(got[:, m:].numpy(),
                                      fresh[:, m:].numpy(), err_msg=f)
    np.testing.assert_array_equal(e[:, :m].numpy(), tree["e_prev"][:, 3 * b:])
    np.testing.assert_array_equal(
        e[:, m:].numpy(), np.tile(np.arange(n, s_p.shape[1]), (LEVELS, 1)))
    assert (stable, it) == (2, 8)
    np.testing.assert_array_equal(trace, tree["trace"])
