"""One whole train step of the port (``repro_torch.train.make_train_step``)
against the JAX reference's jitted step, on the CPU (``-smoke`` configs;
the reference's parameters carried in by ``convert.lm_params_from_numpy``,
numpy inputs through both), plus the step's own properties: every family
steps without NaNs, and train mode recomputes each unit in backward with
the forward's routing.

Tolerances (five families that reach every code path: dense, MoE with
its aux loss, recurrent, the VLM's dropped image prefix, the
encoder-decoder's recompute):
- float32 compute (both packages' ``COMPUTE_DTYPE`` patched to float32):
  loss, ce and aux within ``ATOL_F32`` (1e-4; seen <= 1.4e-6); ``opt.mu``
  and ``opt.nu`` after the step (the clipped gradients and their squares)
  within ``ATOL_F32`` of each leaf's largest |value|, floored at 1e-3 of
  the tree's largest (``tests/_torch_train.py``'s ``moment_err`` says
  why; seen <= 6.3e-6).
- bfloat16 (the configs as they are): within max(``ATOL_BF16``,
  ``REF_SHARE`` x the reference's own bfloat16 error against its float32
  run), the same measures. Seen: the reference's own moment error
  0.019-0.085 of a leaf, the port's distance to it 0.019-0.067.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_lm import (  # noqa: E402,F401
    ATOL_BF16, ATOL_F32, REF_SHARE, float32_compute, make_inputs, make_pair,
    one_torch_thread,
)
from _torch_train import moment_err, port_step, ref_step  # noqa: E402
from repro_torch.configs import ShapeConfig, arch_names, get_arch  # noqa
from repro_torch.convert import train_state_to_numpy  # noqa: E402
from repro_torch.models import (  # noqa: E402
    Mode, make_inputs as model_inputs, model_init,
)
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.loop import _loss_fn, init_train_state  # noqa: E402

SMOKE_SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")


@pytest.mark.parametrize("name", arch_names())
def test_one_train_step_no_nans(name):
    """tests/test_models_smoke.py's step on the port, every family."""
    cfg = get_arch(name + "-smoke")
    gen = torch.Generator().manual_seed(0)
    inputs = model_inputs(cfg, SMOKE_SHAPE, generator=gen, device="cpu")
    params, _ = model_init(gen, cfg, device="cpu")
    step = make_train_step(cfg, Mode("train", "dense"),
                           lr_kwargs={"peak": 1e-3, "warmup": 1, "total": 10})
    state, metrics = step(init_train_state(params), inputs)
    assert bool(metrics["grad_finite"])
    assert np.isfinite(float(metrics["loss"]))
    assert int(state.step) == 1


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen3-moe-235b-a22b",
                                  "recurrentgemma-9b", "internvl2-2b",
                                  "whisper-base"])
def test_train_step_matches_reference(name, record_property):
    pair = make_pair(name + "-smoke")
    inputs = make_inputs(pair.cfg, 2, 16)
    runs = {}
    for f32 in (False, True):
        with float32_compute() if f32 else contextlib.nullcontext():
            ref_st, ref_m = ref_step(pair, inputs)
            st, m = port_step(pair, inputs)
        runs[f32] = ref_st, ref_m, train_state_to_numpy(st), m
    (ref_st, ref_m, st, m), (ref32, ref_m32, st32, m32) = runs[False], \
        runs[True]
    for key in ("loss", "ce", "aux"):
        assert abs(m32[key] - ref_m32[key]) <= ATOL_F32, key
        tol = max(ATOL_BF16, REF_SHARE * abs(ref_m[key] - ref_m32[key]))
        assert abs(m[key] - ref_m[key]) <= tol, key
    for key in ("lr", "grad_finite"):
        assert m[key] == ref_m[key] and m32[key] == ref_m32[key]
    for field in ("mu", "nu"):
        f = lambda s: getattr(s.opt, field)  # noqa: E731
        err32 = moment_err(f(st32), f(ref32))
        own = moment_err(f(ref_st), f(ref32))
        err = moment_err(f(st), f(ref_st))
        record_property(f"{field}_f32_err", err32)
        record_property(f"{field}_bf16_err", err)
        record_property(f"{field}_ref_own_bf16_err", own)
        assert err32 <= ATOL_F32, (field, err32)
        assert err <= max(ATOL_BF16, REF_SHARE * own), (field, err, own)
    assert int(st.opt.count) == int(ref_st.opt.count) == 1
    assert int(st.step) == int(ref_st.step) == 1


def _grads(model, cfg, inputs):
    model.zero_grad(set_to_none=True)
    loss, _ = _loss_fn(model, cfg, inputs, Mode("train", "dense"))
    loss.backward()
    out = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen3-moe-235b-a22b",
                                  "recurrentgemma-9b", "whisper-base"])
def test_train_mode_recomputes_each_unit(name, monkeypatch):
    """Train mode under autograd checkpoints each pattern unit (each
    decoder layer of the encoder-decoder), as the reference's
    ``jax.checkpoint``: the gradients equal those of the same step without
    recompute bit for bit, and the MoE's routing recomputed in backward
    equals the forward's (a stable sort of a float32 product)."""
    from repro_torch.models import encdec, lm
    from repro_torch.models.layers import moe

    cfg = get_arch(name + "-smoke")
    model, _ = model_init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    inputs = {k: torch.as_tensor(v) for k, v in make_inputs(cfg).items()}
    calls, routes = [], []
    checkpoint = lm.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn)
        return checkpoint(fn, *args, **kw)

    route = moe._route_and_dispatch

    def spy(*args, **kw):
        out = route(*args, **kw)
        inv, _, _, flat_e = out[1]
        routes.append((inv.clone(), flat_e.clone()))
        return out

    monkeypatch.setattr(moe, "_route_and_dispatch", spy)
    for mod in (lm, encdec):
        monkeypatch.setattr(mod, "checkpoint", counted)
    with_remat = _grads(model, cfg, inputs)
    units = (cfg.n_layers if cfg.family == "audio"
             else cfg.n_layers // len(cfg.pattern))
    assert len(calls) == units
    if cfg.n_experts:
        n = len(routes) // 2
        assert n == units and len(routes) == 2 * n
        for fwd, again in zip(routes[:n], reversed(routes[n:])):
            assert all(torch.equal(a, b) for a, b in zip(fwd, again))
    for mod in (lm, encdec):
        monkeypatch.setattr(mod, "checkpoint",
                            lambda fn, *args, use_reentrant: fn(*args))
    plain = _grads(model, cfg, inputs)
    assert with_remat.keys() == plain.keys()
    for key in plain:
        assert torch.equal(with_remat[key], plain[key]), key
    with torch.no_grad():                 # serving: no recompute
        calls.clear()
        for mod in (lm, encdec):
            monkeypatch.setattr(mod, "checkpoint", counted)
        _loss_fn(model, cfg, inputs, Mode("train", "dense"))
    assert not calls
