"""The port's fault tolerance on the CPU against the JAX reference:
``repro_torch.checkpoint``, ``repro_torch.runtime.faultinject`` and the
checkpoint/resume of ``dense_topk`` and ``coarsen``
(``repro_torch.solver.checkpointing``).

* Decisions and state are held **bit for bit**: a checkpointed solve, and
  a solve crashed by an injected fault and resumed, must equal the plain
  solve of the same package exactly — exemplars, labels, trace,
  n_sweeps, converged, and for ``dense_topk`` the final s/r/a/tau/phi/c.
  The three runs execute the same sweeps on the same state, so any
  difference is a fault.
* The on-disk format is the reference's: the manifest's path strings must
  be the ones ``jax.tree_util.tree_flatten_with_path`` gives, and a
  directory written by either package must restore, and resume, in the
  other. A run resumed across packages continues from the other
  package's state, and the float drift between the packages (XLA's FMAs,
  ``ROADMAP.md`` C2) enters the state: decisions must be the reference's
  exactly, r and a within ``STATE_RTOL`` of each field's largest |value|.
* Inputs that reach both packages' solves are shared (L, N, N) stacks or
  stacks built by the reference, so neither side's similarity build
  enters the comparison.
"""
import collections
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import ckpt as j_ckpt  # noqa: E402
from repro.core.preferences import median_preference  # noqa: E402
from repro.core.similarity import (  # noqa: E402
    pairwise_similarity, set_preferences, stack_levels,
)
from repro.data import gaussian_blobs  # noqa: E402
from repro.runtime import faultinject as j_fi  # noqa: E402
from repro.solver import SolveConfig as JConfig  # noqa: E402
from repro.solver import checkpointing as j_ckp  # noqa: E402
from repro.solver import solve as j_solve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, restore_tree, save_tree,
)
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.hap import HAPState  # noqa: E402
from repro_torch.runtime import faultinject  # noqa: E402
from repro_torch.runtime.faultinject import (  # noqa: E402
    FaultInjector, InjectedFault, Rule,
)
from repro_torch.solver import SolveConfig, checkpointing, solve  # noqa: E402

STATE_RTOL = 5e-4   # |port - ref| of r, a over the field's largest |value|


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops: intra-op threads beside the suite's other workers
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pts(n=160, seed=0):
    x, _ = gaussian_blobs(n=n, k=5, seed=seed, spread=0.3, box=14.0)
    return x


@pytest.fixture(scope="module")
def stack3():
    """A shared (3, 160, 160) stack with the median preference, built by
    the reference: both packages solve the same S."""
    s = pairwise_similarity(jnp.asarray(_pts()))
    s = set_preferences(s, median_preference(s))
    return np.asarray(stack_levels(s, 3))


def _same(a, b, state=True):
    np.testing.assert_array_equal(a.exemplars, b.exemplars)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.n_sweeps == b.n_sweeps and a.converged == b.converged
    np.testing.assert_array_equal(a.trace, b.trace)
    if state:
        for name, p, q in zip(HAPState._fields, a.state.hap, b.state.hap):
            assert torch.equal(p, q), name
        assert torch.equal(a.state.idx, b.state.idx)


def _crash(fn, rule):
    inj = FaultInjector().add(rule)
    with faultinject.active(inj), pytest.raises(InjectedFault):
        fn()
    return inj


# ------------------------------------------------------------ checkpoint
NT = collections.namedtuple("NT", ["x", "y"])


def _nested(seed=0):
    g = np.random.default_rng(seed)
    return {"a": torch.from_numpy(g.standard_normal((4, 3)).astype(
                np.float32)),
            "nested": {"b": np.arange(5), "c": np.float32(1.5),
                       "z": None},
            "seq": [np.int32(7), (g.integers(0, 9, (2, 2)),
                                  NT(np.zeros(3, np.float32),
                                     {2: np.ones(1), 10: np.int64(3)}))]}


def _carry():
    g = np.random.default_rng(1)
    tree = {k: g.standard_normal((3, 8, 5)).astype(np.float32)
            for k in ("s", "r", "a")}
    tree.update({k: g.standard_normal((3, 8)).astype(np.float32)
                 for k in ("tau", "phi", "c")})
    tree.update(e_prev=g.integers(0, 8, (3, 8)).astype(np.int32),
                stable=np.int32(2), it=np.int32(8),
                trace=np.full(20, -1, np.int32))
    return tree


@pytest.mark.parametrize("tree", [
    _nested, _carry, lambda: checkpointing._carry_like(),
    lambda: HAPState(*(np.zeros((2, 3), np.float32),) * 6),
    lambda: np.arange(3)], ids=["nested", "carry", "carry_like", "hapstate",
                                "bare_leaf"])
def test_manifest_paths_are_jax_key_paths(tree):
    """The port writes the path strings jax's ``tree_flatten_with_path``
    gives, in its leaf order (dict keys sorted, None an empty subtree)."""
    t = tree()
    flat, _ = jax.tree_util.tree_flatten_with_path(t)
    want = ["/".join(str(k) for k in path) for path, _ in flat]
    paths, leaves = ckpt._flatten_with_paths(t)
    assert paths == want
    for got, (_, leaf) in zip(leaves, flat):
        np.testing.assert_array_equal(ckpt.to_host(got), np.asarray(leaf))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_directories_cross_between_packages(tmp_path, writer):
    """A tree saved by either package restores in the other, leaves bit
    for bit, manifest equal."""
    t = _nested()
    host = jax.tree.map(ckpt.to_host, t)
    path = str(tmp_path / "ck")
    if writer == "port":
        save_tree(path, t, step=3)
        back = j_ckpt.restore_tree(path, host)
    else:
        j_ckpt.save_tree(path, host, step=3)
        back = restore_tree(path, t)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype
    save_tree(str(tmp_path / "p"), t, step=3)
    j_ckpt.save_tree(str(tmp_path / "j"), host, step=3)
    manifests = [json.load(open(tmp_path / d / "manifest.json"))
                 for d in ("p", "j")]
    assert manifests[0] == manifests[1]


def test_restore_keeps_structure_and_refuses_another(tmp_path):
    t = _nested()
    save_tree(str(tmp_path / "ck"), t, step=7)
    back = restore_tree(str(tmp_path / "ck"), t)
    assert isinstance(back["seq"][1][1], NT) and back["nested"]["z"] is None
    np.testing.assert_array_equal(back["a"], t["a"].numpy())
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_tree(str(tmp_path / "ck"), {"different": np.zeros(3)})


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"x": torch.full((2,), float(step))})
    assert mgr.steps() == [3, 4]
    step, tree = mgr.restore_latest({"x": np.zeros(2)})
    assert step == 4
    np.testing.assert_array_equal(tree["x"], [4.0, 4.0])


def test_manager_async_save_gathers_before_handing_off(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    x = torch.arange(4.0)
    mgr.save(10, {"x": x})
    x.zero_()                       # the saved copy was taken already
    mgr.wait()
    assert mgr.steps() == [10]
    np.testing.assert_array_equal(mgr.restore_latest({"x": 0})[1]["x"],
                                  [0.0, 1.0, 2.0, 3.0])
    assert CheckpointManager(str(tmp_path / "e")).restore_latest({}) is None


# ------------------------------------------------------------ faultinject
def test_nth_rule_fires_exact_window():
    inj = FaultInjector().add(Rule("site", nth=2, times=2))
    fired = []
    for i in range(6):
        try:
            inj._fire("site", {"i": i})
            fired.append(False)
        except InjectedFault:
            fired.append(True)
    assert fired == [False, False, True, True, False, False]
    assert inj.hits("site") == 6
    assert [e["hit"] for e in inj.events] == [2, 3]


def test_match_filters_hit_counter():
    inj = FaultInjector().add(Rule("launch", nth=1, match={"worker": 1}))
    seen = []
    for w in (0, 1, 0, 1, 1):
        try:
            inj._fire("launch", {"worker": w})
            seen.append("ok")
        except InjectedFault:
            seen.append("boom")
    assert seen == ["ok", "ok", "ok", "boom", "ok"]


def test_matchonly_rule_fires_first_hits():
    inj = FaultInjector().add(Rule("s", match={"stage": "global"}))
    inj._fire("s", {"stage": "local"})
    with pytest.raises(InjectedFault):
        inj._fire("s", {"stage": "global"})
    inj._fire("s", {"stage": "global"})


def _pattern(module, seed, n=40):
    inj = module.FaultInjector(seed=seed).add(
        module.Rule("p", prob=0.3, times=1000))
    out = []
    for _ in range(n):
        try:
            inj._fire("p", {})
            out.append(0)
        except module.InjectedFault:
            out.append(1)
    return out


def test_prob_rule_fires_on_the_reference_hits():
    """Seeded ``prob`` rules: deterministic per seed, and the SHA-256 draw
    fires on exactly the hits the reference's does."""
    a, b, c = (_pattern(faultinject, s) for s in (7, 7, 8))
    assert a == b and a != c and 0 < sum(a) < 40
    for seed in (0, 7, 8):
        assert _pattern(faultinject, seed) == _pattern(j_fi, seed)


def test_custom_exception_type():
    class Boom(RuntimeError):
        pass
    inj = FaultInjector().add(Rule("x", nth=0, exc=Boom))
    with pytest.raises(Boom):
        inj._fire("x", {})


def test_active_context_installs_and_clears():
    assert faultinject.get() is None
    inj = FaultInjector()
    with faultinject.active(inj) as got:
        assert got is inj and faultinject.get() is inj
        faultinject.fire("anything", foo=1)
        assert inj.hits("anything") == 1
    assert faultinject.get() is None
    faultinject.fire("anything")
    assert inj.hits("anything") == 1


# ---------------------------------------------------- dense_topk resume
def _topk_cfg(d, stop, levels, **kw):
    return SolveConfig(backend="dense_topk", k=16, stop=stop, levels=levels,
                       max_iterations=60, patience=5, preference="median",
                       checkpoint_every=4, checkpoint_dir=d, device="cpu",
                       keep_state=True, **kw)


@pytest.mark.parametrize("stop,levels", [("converged", 1), ("converged", 3),
                                         ("fixed", 3)])
def test_checkpointed_and_resumed_solves_equal_the_plain_one(tmp_path, stop,
                                                             levels):
    """checkpoint_every on (no crash), then a crash at the second segment
    boundary and a resume: both bit-equal to the plain solve, state
    included. (L = 1 converges at sweep 40, L = 3 runs to the budget.)"""
    x = _pts()
    d = str(tmp_path / "ck")
    cfg = _topk_cfg(d, stop, levels)
    plain = solve(x, cfg.replace(checkpoint_every=0, checkpoint_dir=None))
    if levels == 1:
        assert plain.converged and plain.n_sweeps < 60
    _same(solve(x, cfg), plain)
    _crash(lambda: solve(x, cfg), Rule("solver.sweep", nth=1))
    _same(solve(x, cfg.replace(resume_from=d)), plain)


def test_resume_skips_completed_sweeps(tmp_path):
    """The resumed run fires fewer segment boundaries than a fresh one,
    and resuming a finished run reports it straight from disk."""
    x = _pts()
    d = str(tmp_path / "ck")
    cfg = _topk_cfg(d, "fixed", 3).replace(max_iterations=20)
    full = FaultInjector()
    with faultinject.active(full):
        plain = solve(x, cfg)
    _crash(lambda: solve(x, cfg), Rule("solver.sweep", nth=2))
    resumed = FaultInjector()
    with faultinject.active(resumed):
        _same(solve(x, cfg.replace(resume_from=d)), plain)
    assert 0 < resumed.hits("solver.sweep") < full.hits("solver.sweep") == 5
    again = FaultInjector()
    with faultinject.active(again):
        _same(solve(x, cfg.replace(resume_from=d, checkpoint_every=0)),
              plain)
    assert again.hits("solver.sweep") == 0


@pytest.mark.parametrize("stop", ["converged", "fixed"])
def test_reference_directory_resumes_in_the_port(tmp_path, stop, stack3):
    """The reference checkpoints a solve of a shared (L, N, N) stack and
    crashes at its second segment boundary; the port resumes that
    directory and reaches the reference's uninterrupted decisions."""
    d = str(tmp_path / "ck")
    kw = dict(backend="dense_topk", k=16, stop=stop, max_iterations=40,
              patience=5, checkpoint_every=4, checkpoint_dir=d)
    want = j_solve(stack3, JConfig(**kw).replace(checkpoint_every=0,
                                                 checkpoint_dir=None))
    inj = j_fi.FaultInjector().add(j_fi.Rule("solver.sweep", nth=1))
    with j_fi.active(inj), pytest.raises(j_fi.InjectedFault):
        j_solve(stack3, JConfig(**kw))
    assert CheckpointManager(d).steps() == [4, 8]
    got = solve(stack3, SolveConfig(**kw, resume_from=d, device="cpu",
                                    keep_state=True))
    for f in ("exemplars", "labels", "n_clusters", "trace"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.n_sweeps, got.converged) == (want.n_sweeps, want.converged)
    # the port kept checkpointing into the reference's directory
    assert CheckpointManager(d).steps()[-1] == got.n_sweeps


def test_port_directory_resumes_in_the_reference(tmp_path, stack3):
    d = str(tmp_path / "ck")
    kw = dict(backend="dense_topk", k=16, stop="fixed", max_iterations=24,
              checkpoint_every=8, checkpoint_dir=d)
    want = solve(stack3, SolveConfig(**kw, device="cpu"))
    _crash(lambda: solve(stack3, SolveConfig(**kw, device="cpu")),
           Rule("solver.sweep", nth=1))
    got = j_solve(stack3, JConfig(**kw, resume_from=d))
    np.testing.assert_array_equal(got.exemplars, want.exemplars)
    np.testing.assert_array_equal(got.trace, want.trace)


def test_convert_reads_a_reference_carry(tmp_path, stack3):
    """``convert.carry_from_checkpoint`` returns the port's carry from a
    reference directory: the reference's own arrays, and the step it
    stopped at."""
    d = str(tmp_path / "ck")
    kw = dict(backend="dense_topk", k=16, stop="fixed", max_iterations=12,
              checkpoint_every=4, checkpoint_dir=d)
    j_solve(stack3, JConfig(**kw))
    state, e, stable, it, trace = convert.carry_from_checkpoint(d)
    _, tree = j_ckpt.CheckpointManager(d).restore_latest(
        j_ckp._carry_like())
    assert it == 12 and stable == int(tree["stable"])
    for name, t in zip(HAPState._fields, state):
        np.testing.assert_array_equal(t.numpy(), tree[name])
    np.testing.assert_array_equal(e.numpy(), tree["e_prev"])
    np.testing.assert_array_equal(trace, tree["trace"])
    # and the port's own solve of the stack ends within C2 of that state
    port = solve(stack3, SolveConfig(**{**kw, "checkpoint_every": 0,
                                        "checkpoint_dir": None},
                                     device="cpu", keep_state=True))
    for name in ("r", "a"):
        got = getattr(port.state.hap, name).numpy()
        want = tree[name]
        assert np.abs(got - want).max() <= STATE_RTOL * np.abs(want).max()


# ------------------------------------------------------------- coarsen
COARSEN_CFG = dict(backend="coarsen", partition_size=64, coarsen_batch=2,
                   stop="converged", max_iterations=60, patience=5,
                   preference="median", device="cpu")


@pytest.mark.parametrize("stage", ["local", "global"])
def test_coarsen_crash_resume(tmp_path, stage):
    """A crash between local batch groups resumes at the interrupted
    group (fewer stage boundaries re-fired); a crash after the global
    solution was saved resumes past the global solve (none re-fired)."""
    x = _pts(n=600, seed=3)
    d = str(tmp_path / "ck")
    cfg = SolveConfig(**COARSEN_CFG, checkpoint_every=2, checkpoint_dir=d)
    plain = solve(x, cfg.replace(checkpoint_every=0, checkpoint_dir=None))
    rule = (Rule("solver.coarsen", nth=1, match={"stage": "local"})
            if stage == "local" else
            Rule("solver.coarsen", match={"stage": "global"}))
    crashed = _crash(lambda: solve(x, cfg), rule)
    resumed = FaultInjector()
    with faultinject.active(resumed):
        _same(solve(x, cfg.replace(resume_from=d)), plain, state=False)
    if stage == "local":
        assert 0 < resumed.hits("solver.coarsen") \
            < crashed.hits("solver.coarsen") + 2
    else:
        assert resumed.hits("solver.coarsen") == 0 and not resumed.events
    # the reference resumes the port's finished directory past both
    # stages: it only assigns the points, to the port's decisions
    got = j_solve(x, JConfig(**{k: v for k, v in COARSEN_CFG.items()
                                if k != "device"}, resume_from=d))
    np.testing.assert_array_equal(got.exemplars, plain.exemplars)
    assert got.n_sweeps == plain.n_sweeps


# ---------------------------------------------------------- guard rails
def test_resume_rejects_what_it_cannot_resume(tmp_path):
    x = _pts()
    d = str(tmp_path / "ck")
    cfg = _topk_cfg(d, "fixed", 3).replace(max_iterations=8)
    solve(x, cfg)
    with pytest.raises(ValueError, match="checkpoint/config mismatch"):
        solve(x, cfg.replace(resume_from=d, damping=0.8))
    os.makedirs(tmp_path / "empty")
    checkpointing.write_meta(
        str(tmp_path / "empty"),
        json.load(open(os.path.join(d, checkpointing.META_NAME))))
    with pytest.raises(ValueError, match="holds no step_"):
        solve(x, cfg.replace(resume_from=str(tmp_path / "empty")))
    with pytest.raises(ValueError, match="has no solve_meta.json"):
        solve(x, cfg.replace(resume_from=str(tmp_path)))


def test_checkpoint_config_validation(tmp_path):
    x = _pts(n=32)
    with pytest.raises(ValueError, match="checkpoint_every"):
        solve(x, backend="dense_topk", k=8, checkpoint_every=-1,
              device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        solve(x, backend="dense_topk", k=8, checkpoint_every=2,
              device="cpu")
    with pytest.raises(ValueError, match="dense_parallel"):
        solve(x, backend="dense_parallel", checkpoint_every=2,
              checkpoint_dir=str(tmp_path), device="cpu")


def test_sharded_checkpointing_names_its_queue():
    """With a mesh the checkpointed runner takes the sharded program (held
    to the plain sharded run on gloo ranks in
    ``test_torch_dist_resume.py``), which asks for a 1-D ``workers``
    mesh."""
    from repro_torch.launch.mesh import make_mesh

    with pytest.raises(ValueError, match="1-D mesh"):
        checkpointing.run_topk_checkpointed(
            torch.zeros(1, 2, 2), torch.zeros(2, 2, dtype=torch.int32),
            SolveConfig(), mesh=make_mesh((1, 1), ("rows", "cols")))


def test_meta_matches_the_reference(tmp_path):
    """The sidecar keeps the reference's keys and kinds, so a mismatched
    resume is refused in both packages alike."""
    jcfg = JConfig(k=16, max_iterations=20)
    cfg = SolveConfig(k=16, max_iterations=20)
    assert checkpointing._topk_meta("dense_topk_single", 160, 17, cfg, 1,
                                    None) == \
        j_ckp._topk_meta("dense_topk_single", 160, 17, jcfg, 1, None)
    for pref in ("median", -3.0):
        assert checkpointing.coarsen_meta(600, 2, cfg.replace(
            preference=pref)) == j_ckp.coarsen_meta(
                600, 2, jcfg.replace(preference=pref))
