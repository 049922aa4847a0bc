"""The port's graph subsystem on the CPU against the JAX reference:
``repro_torch.graph.EdgeList``, the Borůvka ``graph_affinity`` backend,
edge-list input to every ported backend, and ``preseed="graph"``.

Every comparison is exact, tie-breaks included:

* ``EdgeList`` is host numpy in both packages with the same calls, so
  every array it returns must be bit-equal to ``repro.graph.EdgeList``'s
  on the same input arrays.
* Borůvka's labels, rounds, convergence flag and per-round trace must
  equal the reference's ``run_graph_affinity`` and the numpy oracle (the
  contract of ``tests/test_graph.py``, copied here) on duplicate-heavy
  graphs — weights from a 3-value set, so nearly every selection is a
  tie — and on graphs with isolated nodes.
* ``solve(EdgeList)`` hands both packages the same edges: decisions must
  be equal on ``graph_affinity``, ``dense_topk`` (native) and the dense
  backends (densified).
* From points each package builds its own similarities, and their values
  differ in the last bits (``ROADMAP.md`` C5); Borůvka's max-weight
  selection and the preseed's graph pass can turn on such a bit. So the
  points paths run on integer-valued points, where every square, product
  and sum is exact and both builds store the same (vals, idx) bit for bit
  (asserted), and on float points the port's graph pass is held to the
  reference's on the reference's own built edges.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.similarity import pairwise_similarity as j_pairwise  # noqa: E402
from repro.data import gaussian_blobs  # noqa: E402
from repro.graph import EdgeList as JEdgeList  # noqa: E402
from repro.graph import affinity as j_aff  # noqa: E402
from repro.graph.edges import inert_fill as j_inert_fill  # noqa: E402
from repro.solver import SolveConfig as JConfig  # noqa: E402
from repro.solver import solve as j_solve  # noqa: E402
from repro.solver.topk_build import build_topk_similarity as j_build  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.assignments import flatten_pointers  # noqa: E402
from repro_torch.graph import EdgeList  # noqa: E402
from repro_torch.graph import affinity  # noqa: E402
from repro_torch.graph.edges import inert_fill  # noqa: E402
from repro_torch.solver import SolveConfig, solve  # noqa: E402
from repro_torch.solver.topk_build import build_topk_similarity  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops: intra-op threads beside the suite's other workers
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ numpy oracle
def boruvka_oracle(el, target: int = 1, max_rounds=None):
    """Borůvka affinity clustering over a canonical edge list, by the
    contract of ``tests/test_graph.py``: per-cluster best edge = (max
    weight, min destination-leader id), mutual pairs hooked to the smaller
    id, pointer jumping to a fixed point. Returns (label history list,
    n_rounds, converged)."""
    src, dst, w = el.src, el.dst, el.weight
    n = el.n_nodes
    ids = np.arange(n)
    labels = ids.copy()
    hist, rounds = [], 0
    while True:
        if (labels == ids).sum() <= target:
            return hist, rounds, True
        ls, ld = labels[src], labels[dst]
        act = ls != ld
        if not act.any():
            return hist, rounds, True
        if max_rounds is not None and rounds >= max_rounds:
            return hist, rounds, False
        best_w = np.full(n, -np.inf)
        np.maximum.at(best_w, ls[act], w[act])
        ach = act & (w == best_w[ls])
        best_t = np.full(n, n)
        np.minimum.at(best_t, ls[ach], ld[ach])
        parent = ids.copy()
        has = best_t < n
        parent[has] = best_t[has]
        two = (parent[parent] == ids) & (ids < parent)
        parent[two] = ids[two]
        labels = flatten_pointers(parent)[labels]
        hist.append(labels.copy())
        rounds += 1


def duplicate_heavy(n=120, seed=3, weights=(1.0, 2.0, 3.0), isolated=0):
    """Raw (src, dst, weight) arrays of a random multigraph whose weights
    come from a 3-value set, with self-loops and duplicate edges; the
    last ``isolated`` nodes get no edge."""
    rng = np.random.default_rng(seed)
    m = 6 * n
    live = n - isolated
    src = rng.integers(0, live, m).astype(np.int32)
    dst = rng.integers(0, live, m).astype(np.int32)
    w = rng.choice(np.asarray(weights, np.float32), m)
    return src, dst, w, n


def _pair(arrays):
    src, dst, w, n = arrays
    return EdgeList(src, dst, w, n), JEdgeList(src, dst, w, n)


def _int_points(n, seed, dim=2):
    """Integer-valued blobs: both packages' builds are exact on them."""
    x, _ = gaussian_blobs(n=n, k=5, dim=dim, seed=seed, spread=0.4,
                          box=6.0)
    return np.round(x * 4).astype(np.float32)


def _same_result(got, want, trace=True):
    np.testing.assert_array_equal(got.exemplars, want.exemplars)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.n_clusters, want.n_clusters)
    assert (got.n_sweeps, got.converged) == (want.n_sweeps, want.converged)
    assert got.backend == want.backend
    if trace:
        np.testing.assert_array_equal(got.trace, want.trace)


# --------------------------------------------------------- EdgeList basics
GRAPHS = {
    "dup_heavy": lambda: duplicate_heavy(),
    "isolates": lambda: duplicate_heavy(n=150, seed=8, isolated=9),
    "wide_weights": lambda: duplicate_heavy(
        n=200, seed=1, weights=(-1e4, -3.5, 0.25, 7.0, 7.0)),
    "empty": lambda: (np.zeros(0, np.int32), np.zeros(0, np.int32),
                      np.zeros(0, np.float32), 6),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_edgelist_bit_equal_to_the_reference(graph):
    """Every normalization, layout and preference of the port's EdgeList
    equals the reference's on the same arrays."""
    el, jel = _pair(GRAPHS[graph]())
    assert (el.n_nodes, el.n_edges, el.max_degree) == \
        (jel.n_nodes, jel.n_edges, jel.max_degree)
    np.testing.assert_array_equal(el.degrees, jel.degrees)
    assert inert_fill(el.weight) == j_inert_fill(jel.weight)
    for method in ("without_self_loops", "deduplicated", "symmetrized",
                   "canonical"):
        got, want = getattr(el, method)(), getattr(jel, method)()
        for f in ("src", "dst", "weight"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            assert getattr(got, f).dtype == getattr(want, f).dtype
    canon, jcanon = el.canonical(), jel.canonical()
    for k in (None, 1, 3, 17):
        for got, want in zip(canon.to_topk(k), jcanon.to_topk(k)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    np.testing.assert_array_equal(el.to_dense(), jel.to_dense())
    for strategy in ("median", "range_mid", "constant", None, -2.5,
                     np.linspace(-1, 0, el.n_nodes)):
        np.testing.assert_array_equal(el.edge_preferences(strategy),
                                      jel.edge_preferences(strategy))


def test_edgelist_validation():
    for args, match in [
            ((np.zeros((2, 2), np.int32), np.zeros(2, np.int32),
              np.zeros(2)), "1-D"),
            ((np.zeros(3, np.int32), np.zeros(2, np.int32), np.zeros(2)),
             "equal length"),
            ((np.zeros(2), np.zeros(2, np.int32), np.zeros(2)), "integer"),
            ((np.zeros(1, np.int32), np.ones(1, np.int32),
              np.asarray([np.nan])), "finite"),
            ((np.asarray([0], np.int32), np.asarray([7], np.int32),
              np.ones(1), 4), r"lie in \[0, 4\)")]:
        with pytest.raises(ValueError, match=match):
            EdgeList(*args)
    el = EdgeList(np.asarray([0, 5], np.int32), np.asarray([5, 0], np.int32),
                  np.ones(2))
    assert el.n_nodes == 6 and el.n_edges == 2
    with pytest.raises(ValueError, match="unknown preference"):
        el.edge_preferences("bogus")
    with pytest.raises(ValueError, match="k >= 1"):
        el.to_topk(0)


def test_random_edge_preferences_use_the_ports_generator():
    """``"random"`` draws from the port's seeded generator (C3): the same
    seed gives the same vector, another seed another one."""
    el, _ = _pair(duplicate_heavy(n=40))
    a, b = el.edge_preferences("random", seed=3), \
        el.edge_preferences("random", seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32 and a.shape == (40,)
    assert np.all((a >= -1e6) & (a <= 0.0))
    assert not np.array_equal(a, el.edge_preferences("random", seed=4))


@pytest.mark.parametrize("n,k,seed", [(300, 8, 0), (200, 5, 2)])
def test_from_points_and_topk_round_trip(n, k, seed):
    """``from_points`` stores the build's edge set — the reference's, bit
    for bit, on integer points — and ``from_topk(...).to_topk(k)``
    reproduces the build layout (values and column order)."""
    x = _int_points(n, seed)
    x[n // 2:n // 2 + 20] = x[:20]                 # exact duplicate points
    cfg = SolveConfig(device="cpu")
    vals, idx = build_topk_similarity(torch.from_numpy(x), k, cfg)
    jv, ji = j_build(jnp.asarray(x), k, JConfig())
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    el = EdgeList.from_points(x, k, config=cfg)
    jel = JEdgeList.from_points(x, k)
    for f in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(el, f), getattr(jel, f))
    v2, i2 = el.to_topk(k)
    np.testing.assert_array_equal(v2, vals.numpy())
    np.testing.assert_array_equal(i2, idx.numpy())


def test_from_points_needs_cuda_unless_told_otherwise(monkeypatch):
    """Numpy points are built on ``config.device``, "cuda" by default; it
    raises without CUDA rather than building on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EdgeList.from_points(_int_points(40, 0), 4)


# ------------------------------------------------------- Borůvka contract
CASES = [  # (graph, target, max_rounds, levels)
    ("dup_heavy", 1, None, 1), ("dup_heavy", 1, None, 3),
    ("dup_heavy", 7, None, 2), ("dup_heavy", 1, 1, 1),
    ("isolates", 1, None, 3), ("isolates", 25, None, 1),
    ("wide_weights", 2, None, 3), ("wide_weights", 1, 2, 2),
    ("empty", 1, None, 2),
]


@pytest.mark.parametrize("graph,target,max_rounds,levels", CASES)
def test_boruvka_equals_reference_and_oracle(graph, target, max_rounds,
                                             levels):
    el, jel = _pair(GRAPHS[graph]())
    canon = el.canonical()
    vals, idx = canon.to_topk()
    obs.reset_counters("host_copies.graph_affinity")
    hist, r, conv, trace = affinity.run_graph_affinity(
        torch.from_numpy(vals), torch.from_numpy(idx), levels=levels,
        max_rounds=max_rounds, target=target)
    jh, jr, jc, jt = j_aff.run_graph_affinity(
        *jel.canonical().to_topk(), levels=levels, max_rounds=max_rounds,
        target=target)
    assert hist.dtype == torch.int32
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))
    assert (r, conv) == (int(jr), bool(jc))
    np.testing.assert_array_equal(trace, np.asarray(jt))
    # one stop test a round
    assert obs.counters()["host_copies.graph_affinity"] == r
    snaps, rounds, oconv = boruvka_oracle(canon, target, max_rounds)
    # the backend may spend one more round than the oracle, relabeling
    # nothing, to see that nothing is left to hook
    assert rounds <= r <= rounds + 1 and oconv == conv
    snaps = [np.arange(el.n_nodes)] * levels + snaps + \
        [snaps[-1] if snaps else np.arange(el.n_nodes)] * (r - rounds)
    for l in range(levels):
        np.testing.assert_array_equal(hist[l].numpy(),
                                      snaps[len(snaps) - levels + l])


def test_boruvka_components_isolates_and_mesh():
    """The isolated nodes stay singletons, the components contract to
    their smallest ids; a one-rank ``workers`` mesh runs the one-device
    loop (the sharded program is held to the loop on gloo ranks in
    ``test_torch_dist_resume.py``)."""
    el = EdgeList(np.asarray([0, 1, 2, 3], np.int32),
                  np.asarray([1, 0, 3, 2], np.int32),
                  np.ones(4, np.float32), n_nodes=5).canonical()
    res = solve(el, backend="graph_affinity", levels=1, device="cpu")
    assert res.converged
    np.testing.assert_array_equal(res.exemplars[0], [0, 0, 2, 2, 4])
    from repro_torch.launch.mesh import make_worker_mesh

    hist, _, conv, _ = affinity.run_graph_affinity(
        *el.to_topk(), mesh=make_worker_mesh())
    assert conv
    np.testing.assert_array_equal(hist[0].numpy(), [0, 0, 2, 2, 4])


# ------------------------------------------------------ solve(EdgeList)
@pytest.mark.parametrize("graph", ["dup_heavy", "isolates", "wide_weights"])
@pytest.mark.parametrize("backend,kw", [
    ("auto", dict(levels=3)),
    ("graph_affinity", dict(levels=2, graph_target_clusters=5)),
    ("dense_topk", dict(levels=2, max_iterations=30)),
    ("dense_topk", dict(levels=1, k=4, stop="converged",
                        max_iterations=80, preference="range_mid")),
    ("dense_parallel", dict(levels=2, max_iterations=30)),
    ("dense_fused", dict(levels=1, max_iterations=25, preference=-4.0)),
])
def test_solve_edge_list_equals_the_reference(graph, backend, kw):
    el, jel = _pair(GRAPHS[graph]())
    got = solve(el, backend=backend, device="cpu", **kw)
    want = j_solve(jel, backend=backend, **kw)
    _same_result(got, want)
    if backend == "auto":
        assert got.backend == "graph_affinity"


def test_native_edges_keep_every_stored_edge():
    """``dense_topk`` on an edge list keeps k = the deduplicated maximum
    out-degree (no truncation), the reference's layout; a sharper
    ``cfg.k`` cuts by (weight desc, dst asc)."""
    el, _ = _pair(GRAPHS["dup_heavy"]())
    res = solve(el, backend="dense_topk", levels=1, max_iterations=3,
                keep_state=True, device="cpu")
    d = el.without_self_loops().deduplicated()
    assert res.state.idx.shape == (el.n_nodes, d.max_degree + 1)
    res = solve(el, backend="dense_topk", levels=1, max_iterations=3, k=3,
                keep_state=True, device="cpu")
    assert res.state.idx.shape == (el.n_nodes, 4)


@pytest.mark.parametrize("source", ["points", "stack"])
def test_graph_affinity_from_points_and_stacks(source):
    """Points take the top-k build, a stack the row compression of level
    0; on integer points both packages see the same edges."""
    x = _int_points(240, 4)
    data = x if source == "points" else np.asarray(
        j_pairwise(jnp.asarray(x)))[None].repeat(2, axis=0)
    kw = dict(backend="graph_affinity", levels=2, k=6)
    _same_result(solve(data, device="cpu", **kw), j_solve(data, **kw))


# ------------------------------------------------------------ preseed
@pytest.mark.parametrize("backend", ["dense_parallel", "dense_fused",
                                     "dense_topk"])
@pytest.mark.parametrize("kw", [
    dict(k=8),
    dict(k=6, preference=None, graph_target_clusters=9),
    dict(k=8, preference="range_mid", graph_rounds=2),
    dict(k=5, preference=-30.0, levels=1),
])
def test_preseed_stacks_bit_equal_to_the_reference(backend, kw):
    """What ``preseed="graph"`` makes — the preference vector the graph
    pass seeds, written onto the dense diagonal or the top-k self slot —
    is the reference's, bit for bit, on every path (integer points: many
    exact ties, every one broken as the reference breaks it)."""
    from repro.solver import engine as j_engine
    from repro.solver import topk as j_topk
    from repro_torch.solver import engine, topk

    x = _int_points(300, 5)
    cfg = SolveConfig(preseed="graph", device="cpu", **kw)
    jcfg = JConfig(preseed="graph", **kw)
    if backend == "dense_topk":
        got = topk.build_from_points(
            torch.from_numpy(x), cfg.k, cfg.levels, preference=cfg.preference,
            config=cfg)
        want = j_topk.build_from_points(
            jnp.asarray(x), jcfg.k, jcfg.levels, preference=jcfg.preference,
            config=jcfg)
    else:
        got = (engine._build_similarity(torch.from_numpy(x), cfg, backend),)
        want = (j_engine._build_similarity(x, jcfg, backend),)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    plain = engine._build_similarity(torch.from_numpy(x), cfg.replace(
        preseed="off", preference=cfg.preference or 0.0), "dense_parallel")
    seeded = engine._build_similarity(torch.from_numpy(x), cfg,
                                      "dense_parallel")
    assert not torch.equal(plain, seeded)


def _fma_damp(old, new, lam):
    """The reference's jitted damping on the CPU, one rounding
    (``tests/test_torch_topk.py``'s emulation)."""
    lam32 = torch.tensor(lam, dtype=torch.float32).double()
    return (lam32 * old.double() + ((1.0 - lam) * new).double()).float()


@pytest.mark.parametrize("backend,scale,kw", [
    ("dense_topk", 4, dict(levels=1, k=8, max_iterations=60)),
    ("dense_topk", 4, dict(levels=1, k=8, stop="converged",
                           max_iterations=120, graph_target_clusters=9)),
    ("dense_parallel", 64, dict(levels=2, k=8, max_iterations=60)),
    ("dense_fused", 64, dict(levels=1, k=6, max_iterations=40,
                             preference=-30.0 * 256, graph_rounds=2)),
])
def test_preseed_graph_equals_the_reference(backend, scale, kw, monkeypatch):
    """``solve(x, preseed="graph")`` end to end. The seeded stacks are the
    reference's (above); the sweeps that follow keep their own float drift
    (C2). On the top-k path at one level that drift is the damping's FMA
    alone, emulated here, so the decisions must be equal however the run
    flickers; on the dense paths it is not, and these inputs (a coarser
    integer grid, fewer exact ties) are ones where it moves no decision."""
    from repro_torch.core import hap

    if backend == "dense_topk":
        monkeypatch.setattr(hap, "_damp", _fma_damp)
    x, _ = gaussian_blobs(n=300, k=5, dim=2, seed=5, spread=0.4, box=6.0)
    x = np.round(x * scale).astype(np.float32)
    got = solve(x, backend=backend, preseed="graph", device="cpu", **kw)
    want = j_solve(x, backend=backend, preseed="graph", **kw)
    _same_result(got, want)


@pytest.mark.parametrize("base", ["pref", 0.0])
def test_preseed_preferences_on_the_references_edges(base):
    """On float points the builds differ in the last bits (C5); given the
    reference's own (vals, idx), the port's graph pass yields the
    reference's preference vector bit for bit."""
    x, _ = gaussian_blobs(n=300, k=5, seed=0, spread=0.3, box=14.0)
    jv, ji = j_build(jnp.asarray(x), 8, JConfig())
    b = np.linspace(-9.0, -1.0, 300).astype(np.float32) if base == "pref" \
        else base
    got = affinity.preseed_preferences(
        torch.from_numpy(np.array(jv)), torch.from_numpy(np.array(ji)), b)
    want = j_aff.preseed_preferences(jv, ji, b)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------- validation
def test_graph_config_and_preseed_validation():
    el, _ = _pair(duplicate_heavy(n=16, seed=0))
    x = _int_points(32, 0)
    for kw, match in [(dict(graph_rounds=0), "graph_rounds"),
                      (dict(graph_target_clusters=0), "graph_target_clusters"),
                      (dict(preseed="bogus"), "preseed")]:
        with pytest.raises(ValueError, match=match):
            solve(el, device="cpu", **kw)
    with pytest.raises(ValueError, match="IS the graph pass"):
        solve(x, backend="graph_affinity", preseed="graph", device="cpu")
    with pytest.raises(ValueError, match="point input"):
        solve(el, backend="dense_topk", preseed="graph", device="cpu")
    with pytest.raises(ValueError, match="preference array"):
        solve(x, backend="sharded_streaming", preseed="graph", device="cpu")
    for backend in ("sharded_streaming", "coarsen"):
        with pytest.raises(ValueError, match="EdgeList carries no point"):
            solve(el, backend=backend, device="cpu")
