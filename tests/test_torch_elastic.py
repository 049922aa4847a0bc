"""Elastic resharding and the mesh train step on CPU gloo ranks — the
counterparts of ``tests/test_elastic.py`` (``tests/helpers/elastic_check.py``)
and of ``tests/test_runtime_fault.py``'s ``validate_mesh_change`` tests.

One 4-rank group runs every case:

* the reference helper's schedule on tinyllama-1.1b-smoke: 4 steps of
  8 x 32 on a 2 x 2 (data, model) mesh, a checkpoint of the whole state
  (the blocks gathered, the mesh's first rank writing), 4 more steps; then
  the checkpoint restored onto a 1 x 2 mesh (half the ranks lost) and the
  same 4 steps: losses within 1e-3 of the uninterrupted run (the helper's
  bar);
* the mesh step against one process in float32 compute, 3 steps: losses,
  the parameters and the moments within 1e-4, on tinyllama-1.1b-smoke and
  on the qwen3-moe ``-smoke`` family with 4, 3 and 17 experts (both
  sharded layouts, and both ways the expert gradients reach their moment
  blocks; at ``capacity_factor=8.0``, where the sharded dispatch drops
  nothing, so its routing is the dense one's);
  the MoE family also trains on the mesh at its own 1.25 (finite, ce
  falling);
* the reference's ``CheckpointManager`` restores the mesh checkpoint with
  parameters equal to the mesh run's.

JAX is imported inside the tests: the ranks import this module.
"""
import dataclasses
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.runtime.elastic import validate_mesh_change  # noqa: E402
from repro_torch.sharding import dist  # noqa: E402

WORLD = 4
LR = {"peak": 1e-3, "warmup": 2, "total": 20}      # the helper's schedule
F32_TOL = 1e-4


def _f32_compute(on: bool) -> None:
    """The port's ``COMPUTE_DTYPE`` set to float32 (or back to bfloat16)
    in every module that holds it."""
    for name, mod in list(sys.modules.items()):
        if name.startswith("repro_torch.models") and hasattr(
                mod, "COMPUTE_DTYPE"):
            mod.COMPUTE_DTYPE = torch.float32 if on else torch.bfloat16


def _fresh(cfg):
    from repro_torch.models import model_init
    from repro_torch.train.loop import init_train_state, train_state_specs
    model, specs = model_init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    return init_train_state(model), train_state_specs(specs)


def _batches(cfg, n: int) -> list:
    from repro_torch.data.pipeline import synthetic_token_stream
    stream = synthetic_token_stream(cfg.vocab, 8, 32, seed=0)
    return [{"tokens": torch.as_tensor(next(stream))} for _ in range(n)]


#: the f32 comparison's configs: dense; the MoE with 4 experts
#: (expert-parallel over "model"; its moment specs split the hidden dim
#: over "model", so the expert gradients are summed over it), 3 (the
#: hidden dim split, as the specs split it) and 17 (the hidden dim split,
#: while the specs' expert dim cannot divide: summed over "model")
FAMILIES = {"dense": ("tinyllama-1.1b-smoke", None),
            "moe": ("qwen3-moe-235b-a22b-smoke", 4),
            "moe_ffn": ("qwen3-moe-235b-a22b-smoke", 3),
            "moe_17": ("qwen3-moe-235b-a22b-smoke", 17)}


def _config(family: str):
    """``FAMILIES``'s config, a MoE at ``capacity_factor=8.0`` (nothing
    dropped, so the sharded routing is the dense one's)."""
    from repro_torch.configs import get_arch
    name, experts = FAMILIES[family]
    cfg = get_arch(name)
    if experts is not None:
        cfg = dataclasses.replace(cfg, n_experts=experts,
                                  capacity_factor=8.0)
    return cfg


def _mesh_run(cfg, mesh, steps: int, batches: list):
    """-> (losses, ce, final blocks) of ``steps`` mesh steps from the
    fresh state."""
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.models import Mode
    from repro_torch.train.loop import make_train_step, shard_train_state
    state, specs = _fresh(cfg)
    # the shape-safe layout: 17 experts do not split over "model", which
    # reshard_state refuses as the reference's device_put does
    st = shard_train_state(train_state_to_numpy(state), specs, mesh)
    step = make_train_step(cfg, Mode("train", "dense"), lr_kwargs=LR,
                           mesh=mesh)
    losses, ce = [], []
    for b in batches[:steps]:
        st, m = step(st, b)
        losses.append(float(m["loss"]))
        ce.append(float(m["ce"]))
    return losses, ce, st


def _one_run(cfg, steps: int, batches: list):
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.models import Mode
    from repro_torch.train.loop import make_train_step
    state, _ = _fresh(cfg)
    step = make_train_step(cfg, Mode("train", "dense"), lr_kwargs=LR)
    losses = []
    for b in batches[:steps]:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, train_state_to_numpy(state)


def _full(st, specs, mesh, like=None) -> dict:
    """The whole state, numpy, from the blocks (every rank); with ``like``
    (the state's whole tree) under the shape-safe layout of
    ``_mesh_run``'s states."""
    from repro_torch.models.layers.common import tree_map
    from repro_torch.runtime.elastic import gather_state
    from repro_torch.sharding.partitioning import (
        Sharding, shape_safe_shardings,
    )
    if like is None:
        full = gather_state(st, specs, mesh)
    else:
        full = tree_map(lambda sh, b: sh.gather(b),
                        shape_safe_shardings(mesh, like, specs), st,
                        is_leaf=lambda x: isinstance(x, Sharding))
    return tree_map(lambda t: t.numpy(), full)


def _rank(ckdir: str) -> dict:
    import torch.distributed as tdist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Mode
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.train.loop import make_train_step

    out = {}
    cfg = get_arch("tinyllama-1.1b-smoke")
    batches = _batches(cfg, 8)
    # ---- the elastic schedule: phase 1 on 2 x 2, a save, 4 more steps
    mesh1 = make_mesh((2, 2), ("data", "model"))
    mesh2 = make_mesh((1, 2), ("data", "model"))    # every rank builds it
    _, _, st = _mesh_run(cfg, mesh1, 4, batches)
    state, specs = _fresh(cfg)
    full = _full(st, specs, mesh1)
    if dist.rank() == 0:
        CheckpointManager(ckdir, async_save=False).save(4, full)
    tdist.barrier()
    step = make_train_step(cfg, Mode("train", "dense"), lr_kwargs=LR,
                           mesh=mesh1)
    ref_losses = []
    for b in batches[4:]:
        st, m = step(st, b)
        ref_losses.append(float(m["loss"]))
    out["ref_losses"] = ref_losses
    out["saved_params"] = full.params if dist.rank() == 0 else None
    # ---- phase 2: "half the ranks lost": restore onto 1 x 2
    if mesh2.member:
        like = train_state_to_numpy(state)
        step_no, restored = CheckpointManager(ckdir).restore_latest(like)
        st2 = reshard_state(restored, specs, mesh2, device="cpu")
        step2 = make_train_step(cfg, Mode("train", "dense"), lr_kwargs=LR,
                                mesh=mesh2)
        new_losses = []
        for b in batches[4:]:
            st2, m = step2(st2, b)
            new_losses.append(float(m["loss"]))
        out.update(restored_step=step_no, new_losses=new_losses)
    tdist.barrier()

    # ---- the mesh step against one process, float32 compute
    _f32_compute(True)
    try:
        for name in FAMILIES:
            c = _config(name)
            losses, _, st = _mesh_run(c, mesh1, 3, _batches(c, 3))
            state, specs = _fresh(c)
            full = _full(st, specs, mesh1, train_state_to_numpy(state))
            out[f"f32_{name}"] = (losses, full if dist.rank() == 0 else None)
    finally:
        _f32_compute(False)
    moe = get_arch("qwen3-moe-235b-a22b-smoke")
    losses, ce, _ = _mesh_run(moe, mesh1, 6, _batches(moe, 6))
    out["moe_default"] = (losses, ce)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ckdir = str(tmp_path_factory.mktemp("mesh_ckpt"))
    return ckdir, dist.spawn(_rank, WORLD, args=(ckdir,))


def test_elastic_restart_preserves_training(ranks):
    _, out = ranks
    for r in out[:2]:                       # the 1 x 2 mesh's ranks
        assert r["restored_step"] == 4
        err = max(abs(a - b) for a, b in zip(r["ref_losses"],
                                             r["new_losses"]))
        assert err < 1e-3, (r["ref_losses"], r["new_losses"])
    assert all("new_losses" not in r for r in out[2:])
    for r in out[1:]:                       # the same on every rank
        assert r["ref_losses"] == out[0]["ref_losses"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_mesh_step_matches_one_process_f32(ranks, family):
    from repro_torch.models.layers.common import tree_map
    _, out = ranks
    cfg = _config(family)
    _f32_compute(True)
    try:
        losses, state = _one_run(cfg, 3, _batches(cfg, 3))
    finally:
        _f32_compute(False)
    mesh_losses, full = out[0][f"f32_{family}"]
    assert max(abs(a - b) for a, b in zip(losses, mesh_losses)) <= F32_TOL
    gaps = []
    tree_map(lambda a, b: gaps.append(float(np.abs(a - b).max())),
             (state.params, state.opt.mu, state.opt.nu),
             (full.params, full.opt.mu, full.opt.nu))
    assert max(gaps) <= F32_TOL
    assert int(full.step) == 3 and int(full.opt.count) == 3


def test_moe_family_trains_on_the_mesh(ranks):
    _, out = ranks
    losses, ce = out[0]["moe_default"]
    assert np.isfinite(losses).all()
    assert np.mean(ce[-2:]) < ce[0]
    for r in out[1:]:
        assert r["moe_default"] == out[0]["moe_default"]


def test_reference_restores_the_mesh_checkpoint(ranks):
    import jax
    from repro.checkpoint import CheckpointManager
    from repro.configs import get_arch
    from repro.models import model_init
    from repro.train.loop import init_train_state
    ckdir, out = ranks
    params, _ = model_init(jax.random.PRNGKey(0),
                           get_arch("tinyllama-1.1b-smoke"))
    like = init_train_state(params)
    step, restored = CheckpointManager(ckdir).restore_latest(like)
    assert step == 4
    got = jax.tree_util.tree_leaves_with_path(restored.params)
    want = dict(jax.tree_util.tree_leaves_with_path(out[0]["saved_params"]))
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf), want[path])


def test_mesh_step_refuses_compression():
    from repro_torch.configs import get_arch
    from repro_torch.models import Mode
    from repro_torch.train.loop import make_train_step
    cfg = get_arch("tinyllama-1.1b-smoke")
    with pytest.raises(ValueError, match="no compression"):
        make_train_step(cfg, Mode("train", "dense"), compress="topk",
                        mesh=object())


# ------------------------------------------------- validate_mesh_change
def test_mesh_change_clean_transition_no_warnings():
    assert validate_mesh_change({"data": 8}, {"data": 4},
                                global_batch=64) == [
        "data extent shrank: per-device batch grows; "
        "check activation memory headroom"]
    assert validate_mesh_change({"data": 4}, {"data": 8},
                                global_batch=64) == []


def test_mesh_change_warns_on_indivisible_batch():
    ws = validate_mesh_change({"data": 4}, {"data": 3}, global_batch=64)
    assert any("not divisible" in w for w in ws)


def test_mesh_change_warns_on_model_extent_change():
    ws = validate_mesh_change({"data": 4, "model": 2},
                              {"data": 4, "model": 4}, global_batch=64)
    assert ws == ["model-parallel extent changed: parameter layout moves "
                  "between devices (full reshard, ~2x checkpoint-size "
                  "traffic)"]


def test_mesh_change_counts_pod_axis_in_data_extent():
    ws = validate_mesh_change({"data": 2, "pod": 2}, {"data": 2, "pod": 1},
                              global_batch=32)
    assert any("shrank" in w for w in ws)


def _shapes():
    out = []
    for pod in (None, 1, 2):
        for data in (1, 2, 3, 4, 8):
            for model in (None, 1, 2, 16):
                s = {"data": data}
                if pod:
                    s["pod"] = pod
                if model:
                    s["model"] = model
                out.append(s)
    return out


@pytest.mark.parametrize("batch", [1, 24, 64, 96])
def test_mesh_change_grid_equals_reference(batch):
    from repro.runtime.elastic import validate_mesh_change as ref
    shapes = _shapes()
    for old in shapes:
        for new in shapes:
            assert validate_mesh_change(old, new, batch) == ref(
                old, new, batch), (old, new, batch)
