"""The port's training pieces on the CPU (``repro_torch.train``,
``runtime.compression``, ``runtime.fault``, ``launch.train``): the tests
of tests/test_train.py, the compression property of tests/test_property.py
and tests/test_runtime_fault.py's restart tests on the port, with parity
against the JAX reference where both packages compute the same function.

Tolerances:
- ``cosine_warmup``: within one ulp of the peak (float32). XLA's and
  PyTorch's ``cos`` round apart by up to an ulp, and where the cosine nears
  -1, 1 + cos cancels, so the small rates late in the decay may differ by
  a few of their own ulps.
- ``global_norm``: within 8 ulps (the sums of squares reduce in other
  orders).
- ``adamw_update`` from the same numpy parameters, gradients and moments:
  new parameters and moments within 4 ulps of each leaf's largest |value|
  (XLA contracts multiply-adds into FMAs, ROADMAP C2, and where b1 m and
  (1 - b1) g cancel, an ulp of the terms is many of the result's); with
  the clip engaged the global norm's summation order moves the scale by an
  ulp too; the count equal.
- ``topk_compress``: the output equal to the reference's bit for bit (the
  threshold is the k-th largest |g|, whatever order ties take).
- Moments after a step (microbatches against one batch; a checkpoint of
  either package restored and stepped by both): within 1e-4 of each
  leaf's largest |value|, floored at 1e-3 of the tree's largest
  (``tests/_torch_train.py`` says why), in float32 compute; loss, ce and
  aux of the two packages' steps within 1e-4.
"""
import copy
import dataclasses
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_lm import (  # noqa: E402,F401
    ATOL_F32, float32_compute, make_inputs, make_pair, one_torch_thread,
    ref_spec_paths, spec_paths,
)
from _torch_train import moment_err, port_step, ref_step  # noqa: E402
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import model_init as ref_model_init  # noqa: E402
from repro.runtime import compression as ref_comp  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.loop import (  # noqa: E402
    init_train_state as ref_init_state, train_state_specs as ref_train_specs,
)
from repro.train.schedule import cosine_warmup as ref_cosine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    train_state_from_numpy, train_state_to_numpy,
)
from repro_torch.data.pipeline import synthetic_token_stream  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Mode, model_init  # noqa: E402
from repro_torch.models.layers.common import P  # noqa: E402
from repro_torch.runtime.compression import (  # noqa: E402
    compress_tree_grads, topk_compress, topk_with_error_feedback,
)
from repro_torch.runtime.fault import FaultPolicy, run_with_restarts  # noqa
from repro_torch.train import (  # noqa: E402
    adamw_init, adamw_update, cosine_warmup, make_train_step,
    train_state_specs,
)
from repro_torch.train.loop import init_train_state  # noqa: E402
from repro_torch.train.optimizer import global_norm  # noqa: E402

MOMENT_RTOL = 1e-4


def _model(name="tinyllama-1.1b-smoke", seed=0):
    cfg = get_arch(name)
    model, _ = model_init(torch.Generator().manual_seed(seed), cfg,
                          device="cpu")
    return cfg, model


# ------------------------------------------------ tests/test_train.py's
def test_loss_decreases():
    cfg, model = _model()
    state = init_train_state(model)
    step = make_train_step(cfg, Mode("train", "dense"),
                           lr_kwargs={"peak": 1e-2, "warmup": 3,
                                      "total": 30})
    stream = synthetic_token_stream(cfg.vocab, 8, 64, seed=0)
    losses = []
    for _ in range(25):
        state, m = step(state, {"tokens": torch.as_tensor(next(stream))})
        losses.append(float(m["ce"]))
    assert losses[-1] < losses[0] - 0.2
    assert int(state.step) == 25 and int(state.opt.count) == 25


def test_grad_accum_matches_full_batch():
    """Same data, microbatches=2 vs 1: identical grads => identical params
    after one step (CE is a mean, accumulation averages): ce within 1e-4
    and parameters within 1e-5 (lr is 0 at step 0 under warmup 1, as in
    the reference test). What the parameters cannot show then, the
    gradients, the moments show: in float32 compute (in bfloat16 the two
    splits round apart by ~0.5 %) within MOMENT_RTOL."""
    cfg, model = _model()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 32)).astype(np.int32))
    lr = {"peak": 1e-3, "warmup": 1, "total": 10}

    def one(mb):
        return make_train_step(cfg, Mode("train", "dense"), microbatches=mb,
                               lr_kwargs=lr)(
            init_train_state(copy.deepcopy(model)), {"tokens": toks})

    (s1, m1), (s2, m2) = one(1), one(2)
    assert abs(float(m1["ce"]) - float(m2["ce"])) < 1e-4
    with torch.no_grad():
        d = max(float((a - b).abs().max()) for a, b in zip(
            s1.params.parameters(), s2.params.parameters()))
    assert d < 1e-5
    with float32_compute():
        (s1, m1), (s2, m2) = one(1), one(2)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    assert moment_err(s2.opt.mu, s1.opt.mu) <= MOMENT_RTOL
    assert moment_err(s2.opt.nu, s1.opt.nu) <= MOMENT_RTOL


def test_adamw_moves_params_and_counts():
    p = {"w": torch.ones((4, 4))}
    g = {"w": torch.full((4, 4), 0.1)}
    st = adamw_init(p)
    p2, st2 = adamw_update(g, st, p, torch.tensor(1e-2))
    assert int(st2.count) == 1
    assert float((p2["w"] - p["w"]).abs().max()) > 0
    assert torch.equal(p["w"], torch.ones((4, 4)))      # nothing modified


def test_grad_clip_bounds_update():
    p = {"w": torch.zeros((8,))}
    g = {"w": torch.full((8,), 1e6)}
    p2, _ = adamw_update(g, adamw_init(p), p, torch.tensor(1.0),
                         clip_norm=1.0, weight_decay=0.0)
    # with clipping, first-step update magnitude is ~lr regardless of g
    assert float(p2["w"].abs().max()) < 1.5


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(t)) - 5.0) < 1e-6
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((64, 33)).astype(np.float32),
            "b": [rng.standard_normal(517).astype(np.float32),
                  rng.standard_normal((3, 5, 7)).astype(np.float32)]}
    got = global_norm(jax.tree.map(torch.from_numpy, tree))
    want = ref_opt.global_norm(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=8)


def test_schedule_shape():
    warm = float(cosine_warmup(torch.tensor(5), peak=1.0, warmup=10,
                               total=100))
    peak = float(cosine_warmup(torch.tensor(10), peak=1.0, warmup=10,
                               total=100))
    end = float(cosine_warmup(torch.tensor(100), peak=1.0, warmup=10,
                              total=100, floor=0.1))
    assert warm < peak
    assert abs(peak - 1.0) < 1e-2
    assert abs(end - 0.1) < 1e-2


@pytest.mark.parametrize("kw", [
    {"peak": 3e-3, "warmup": 12, "total": 120},
    {"peak": 3e-4, "warmup": 100, "total": 10_000, "floor": 0.1},
    {"peak": 1e-2, "warmup": 0, "total": 30, "floor": 0.0}])
def test_schedule_matches_reference(kw):
    steps = np.arange(121, dtype=np.int32)
    got = np.array([cosine_warmup(torch.tensor(int(s)), **kw).item()
                    for s in steps], np.float32)
    want = np.array([ref_cosine(jnp.asarray(s), **kw) for s in steps],
                    np.float32)
    assert cosine_warmup(torch.tensor(3, dtype=torch.int32)).dtype \
        == torch.float32
    assert np.abs(got - want).max() <= np.spacing(np.float32(kw["peak"]))


def _within_ulps_of_leaf_max(got, want, n: int = 4) -> None:
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                    jax.tree.leaves(jax.tree.map(np.asarray, want))):
        assert np.abs(a - b).max() <= n * np.spacing(np.abs(b).max()), \
            (a.shape, float(np.abs(a - b).max()))


@pytest.mark.parametrize("grad_scale", [0.01, 0.3])
def test_adamw_update_matches_reference(grad_scale):
    """The update alone, from the same numpy parameters, gradients and
    moments (count 4, so the bias corrections are not trivial), with the
    gradients' norm under the clip (scale 1) and over it."""
    from repro_torch.train.optimizer import AdamWState

    rng = np.random.default_rng(2)
    shapes = {"w": (33, 17), "b": (17,), "deep": {"x": (5, 4, 3)}}

    def draw(scale=1.0, positive=False):
        out = jax.tree.map(
            lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))
        return jax.tree.map(np.abs, out) if positive else out

    params, grads = draw(), draw(grad_scale)
    mu, nu = draw(0.01), draw(1e-4, positive=True)
    count = np.int32(4)
    lr = np.float32(2e-3)
    ref_p, ref_st = ref_opt.adamw_update(
        jax.tree.map(jnp.asarray, grads),
        ref_opt.AdamWState(jax.tree.map(jnp.asarray, mu),
                           jax.tree.map(jnp.asarray, nu), jnp.asarray(count)),
        jax.tree.map(jnp.asarray, params), jnp.asarray(lr))
    t = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    got_p, got_st = adamw_update(
        t(grads), AdamWState(t(mu), t(nu), torch.tensor(count)), t(params),
        torch.tensor(lr))
    norm = float(ref_opt.global_norm(jax.tree.map(jnp.asarray, grads)))
    assert (norm > 1) == (grad_scale > 0.1)
    _within_ulps_of_leaf_max(got_p, ref_p)
    _within_ulps_of_leaf_max(got_st.mu, ref_st.mu)
    _within_ulps_of_leaf_max(got_st.nu, ref_st.nu)
    assert int(got_st.count) == int(ref_st.count) == 5


def test_topk_compression_applied():
    cfg, model = _model()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32))
    step = make_train_step(
        cfg, Mode("train", "dense"), compress="topk", compress_ratio=0.05,
        compress_min_size=1024,
        lr_kwargs={"peak": 1e-3, "warmup": 1, "total": 10})
    state, m = step(init_train_state(model), {"tokens": toks})
    assert bool(m["grad_finite"])
    # embedding momentum should be 95% zeros after one compressed step
    mu = state.opt.mu["embed.embedding"].numpy()
    assert (mu == 0).mean() > 0.9


# ------------------------------------------------- runtime.compression
@pytest.mark.parametrize("seed,ratio,shape,kind", [
    (0, 0.01, (257,), "normal"), (1, 0.05, (257,), "normal"),
    (2, 0.3, (64, 48), "normal"), (3, 0.5, (7, 11, 13), "normal"),
    (4, 0.02, (1000,), "ties"), (5, 0.25, (33, 17), "ties"),
    (6, 0.001, (40,), "normal"), (7, 0.1, (3000,), "ties")])
def test_topk_compress_equals_reference(seed, ratio, shape, kind):
    """tests/test_property.py's property on the port, and the output equal
    to the reference's on the same input (ties: integer values, many equal
    to the threshold)."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) if kind == "normal"
         else rng.integers(-4, 5, shape)).astype(np.float32)
    out = topk_compress(torch.from_numpy(g), ratio).numpy()
    want = np.asarray(ref_comp.topk_compress(jnp.asarray(g), ratio))
    np.testing.assert_array_equal(out, want)
    k = max(1, int(g.size * ratio))
    kept = np.count_nonzero(out)
    assert kept >= min(k, np.count_nonzero(g))   # ties keep more, not fewer
    if kept < g.size:
        assert np.abs(out[out != 0]).min() >= np.abs(g[out == 0]).max()
    assert topk_compress(torch.tensor(2.5), ratio).item() == 2.5


def test_compress_tree_grads_min_size_and_error_feedback():
    rng = np.random.default_rng(8)
    tree = {"big": rng.standard_normal((300, 300)).astype(np.float32),
            "small": rng.standard_normal((10, 10)).astype(np.float32),
            "list": [rng.standard_normal(70_000).astype(np.float32)]}
    got = compress_tree_grads(jax.tree.map(torch.from_numpy, tree), 0.02)
    want = ref_comp.compress_tree_grads(jax.tree.map(jnp.asarray, tree),
                                        0.02)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                    jax.tree.leaves(jax.tree.map(np.asarray, want))):
        np.testing.assert_array_equal(a, b)
    assert np.array_equal(got["small"].numpy(), tree["small"])  # < min_size
    assert np.count_nonzero(got["big"].numpy()) == 1_800
    g = rng.standard_normal(4096).astype(np.float32)
    res = (0.1 * rng.standard_normal(4096)).astype(np.float32)
    sent, carry = topk_with_error_feedback(torch.from_numpy(g),
                                           torch.from_numpy(res), 0.05)
    rs, rc = ref_comp.topk_with_error_feedback(jnp.asarray(g),
                                               jnp.asarray(res), 0.05)
    np.testing.assert_array_equal(sent.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(carry.numpy(), np.asarray(rc))
    np.testing.assert_array_equal((sent + carry).numpy(), g + res)


# ---------------------------------------------------------- train specs
@pytest.mark.parametrize("zero", [True, False])
@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen3-moe-235b-a22b",
                                  "whisper-base"])
def test_train_state_specs_mirror_reference(name, zero):
    """The spec tree of the whole state, path by path, at the full
    configs (the port's counted on ``meta``), ZeRO on and off."""
    _, specs = model_init(None, get_arch(name), device="meta")
    box = {}

    def init(key):       # traced only: the specs, no parameter allocated
        params, box["specs"] = ref_model_init(key, ref_arch(name))
        return params
    jax.eval_shape(init, jax.random.PRNGKey(0))
    ref_specs = box["specs"]
    got = spec_paths(train_state_specs(specs, zero=zero),
                     lambda x: isinstance(x, P))
    want = ref_spec_paths(ref_train_specs(ref_specs, zero=zero))
    assert got == want
    assert any("data" in str(s) for s in got.values()) or not zero


# ----------------------------------------------------------- restarts
def test_default_policy_is_fresh_per_call():
    """The policy default must be constructed per call — a shared
    mutable default would let one caller's tweaks leak into the next."""
    sig = inspect.signature(run_with_restarts)
    assert sig.parameters["policy"].default is None
    assert dataclasses.asdict(FaultPolicy()) == {
        "checkpoint_every": 100, "max_restarts": 3, "backoff_s": 1.0,
        "allow_elastic_downsize": True}


def test_succeeds_after_transient_failures():
    calls = {"n": 0}

    def run_fn(state):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return state + calls["n"]

    out = run_with_restarts(run_fn, lambda: 100,
                            FaultPolicy(max_restarts=3, backoff_s=0.0))
    assert out == 103 and calls["n"] == 3


def test_restore_fn_called_every_attempt():
    restores = {"n": 0}

    def restore():
        restores["n"] += 1
        return restores["n"]

    def run_fn(state):
        if state < 2:
            raise RuntimeError("die")
        return state

    assert run_with_restarts(run_fn, restore,
                             FaultPolicy(backoff_s=0.0)) == 2
    assert restores["n"] == 2


def test_exceeding_max_restarts_raises_last_error():
    def run_fn(state):
        raise ValueError("permanent")

    with pytest.raises(ValueError, match="permanent"):
        run_with_restarts(run_fn, lambda: None,
                          FaultPolicy(max_restarts=2, backoff_s=0.0))


def test_keyboard_interrupt_propagates_immediately():
    calls = {"n": 0}

    def run_fn(state):
        calls["n"] += 1
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        run_with_restarts(run_fn, lambda: None,
                          FaultPolicy(max_restarts=5, backoff_s=0.0))
    assert calls["n"] == 1          # not retried


# -------------------------------------------------------- the driver
def test_launch_train_on_the_cpu(capsys):
    assert launch_train.main(["--arch", "tinyllama-1.1b", "--smoke",
                              "--steps", "4", "--device", "cpu"]) == 0
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[train] step")]
    assert [line.split()[2] for line in lines] == ["0", "3"]
    losses = [float(line.split("loss=")[1].split()[0]) for line in lines]
    assert all(np.isfinite(losses))


def test_launch_train_resumes_from_its_checkpoint(tmp_path, capsys):
    """With --ckpt-dir: saves in the reference's layout, and a second run
    restores the newest step and goes on from there."""
    from repro_torch.checkpoint import CheckpointManager

    d = str(tmp_path / "ck")
    args = ["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu",
            "--ckpt-dir", d, "--ckpt-every", "2"]
    assert launch_train.main(args + ["--steps", "4"]) == 0
    assert CheckpointManager(d).steps() == [2, 4]
    first = capsys.readouterr().out
    assert "restored" not in first
    assert launch_train.main(args + ["--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "[train] restored step 4" in out
    assert "[train] step 5 " in out
    assert CheckpointManager(d).steps() == [2, 4, 6]
    import json
    with open(f"{d}/step_0000000006/manifest.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 6
    assert ".opt/.count" in manifest["paths"] and ".step" in manifest["paths"]
    assert ".params/['embed']/['embedding']" in manifest["paths"]


def test_launch_train_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_train.main(["--arch", "tinyllama-1.1b", "--smoke",
                               "--steps", "1", *extra])

# ------------------------------------------- checkpoints across packages
def test_train_checkpoint_crosses_packages(tmp_path):
    """The reference saves its state after a step; the port restores it
    (``CheckpointManager.restore_latest`` into ``train_state_to_numpy``'s
    tree, then ``train_state_from_numpy``) and both take the next step
    from it: equal metrics and moments in float32 compute. Then the port
    saves, the reference restores, and both step again."""
    from repro.checkpoint import CheckpointManager as RefManager
    from repro_torch.checkpoint import CheckpointManager

    pair = make_pair("qwen3-moe-235b-a22b-smoke")
    batches = [make_inputs(pair.cfg, 2, 16, seed=s) for s in range(3)]
    with float32_compute():
        ref_st, _ = ref_step(pair, batches[0])
        ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
        RefManager(ref_dir, async_save=False).save(1, ref_st)
        like = train_state_to_numpy(init_train_state(
            copy.deepcopy(pair.model)))
        step, tree = CheckpointManager(ref_dir).restore_latest(like)
        state = train_state_from_numpy(tree, pair.cfg, device="cpu")
        assert step == 1 and int(state.step) == 1
        assert int(state.opt.count) == 1
        for a, b in zip(jax.tree.leaves(train_state_to_numpy(state)),
                        jax.tree.leaves(ref_st)):
            assert a.dtype == b.dtype and np.array_equal(a, b)

        ref_st, ref_m = ref_step(pair, batches[1], jax.tree.map(
            jnp.asarray, ref_st))
        state, m = port_step(pair, batches[1], state)
        for key in ("loss", "ce", "aux"):
            assert abs(m[key] - ref_m[key]) <= ATOL_F32, key
        host = train_state_to_numpy(state)
        assert moment_err(host.opt.mu, ref_st.opt.mu) <= ATOL_F32
        assert moment_err(host.opt.nu, ref_st.opt.nu) <= ATOL_F32

        CheckpointManager(port_dir, async_save=False).save(2, host)
        step, back = RefManager(port_dir).restore_latest(
            ref_init_state(pair.ref_params))
        assert step == 2 and int(back.step) == 2
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
            assert np.asarray(a).dtype == b.dtype
            assert np.array_equal(np.asarray(a), b)
        ref_st, ref_m = ref_step(pair, batches[2],
                                 jax.tree.map(jnp.asarray, back))
        state, m = port_step(pair, batches[2], state)
    for key in ("loss", "ce", "aux", "lr"):
        assert abs(m[key] - ref_m[key]) <= ATOL_F32, key
    host = train_state_to_numpy(state)
    assert moment_err(host.opt.mu, ref_st.opt.mu) <= ATOL_F32
    assert int(state.step) == int(ref_st.step) == 3
