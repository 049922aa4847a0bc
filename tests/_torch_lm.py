"""Shared parity harness of the port's LM tests (``test_torch_models_*``,
``test_torch_lm_serve``): the reference initialises a model with
``jax.random`` and the port loads the same parameters through
``repro_torch.convert.lm_params_from_numpy``; numpy-seeded inputs go
through both.

Tolerances (measured on the ``-smoke`` configs, B = 2, S = 24):
- float32 compute (both packages' ``COMPUTE_DTYPE`` patched to float32):
  the port's logits equal the reference's within ``ATOL_F32``; the
  largest gap seen was 1.3e-5 (xlstm, whose mLSTM divides by a
  stabilised normaliser), 2.6e-7 to 8.3e-7 elsewhere. This holds the
  formulas.
- bfloat16 compute (the configs as they are): XLA on the CPU keeps excess
  precision between fused bfloat16 operations where PyTorch rounds after
  each one, so each package lands a rounding error away from the exact
  result. The port must stay within ``max(ATOL_BF16, REF_SHARE x the
  reference's own bfloat16 error)`` of the reference's logits, where the
  reference's own error is its bfloat16 run against its float32 run, and
  no further from the float32 result than ``REF_SHARE`` times the
  reference is. Seen: the reference's own error 0.004 (whisper) to 0.0192
  (recurrentgemma) and 0.149 (xlstm), the port's 1.05-1.21x that.
- Greedy tokens: equal wherever the reference's top-2 margin exceeds twice
  the bfloat16 tolerance; the positions under the margin are counted.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import get_arch as ref_arch
from repro.models import (
    Mode as RefMode, model_apply as ref_apply, model_init as ref_init,
    model_state_init as ref_state_init,
)
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import Mode, model_apply, model_state_init

ATOL_F32 = 1e-4
ATOL_BF16 = 2e-2          # tests/test_models_smoke.py's decode bar
REF_SHARE = 1.5
B, S = 2, 24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced models' tensors are tiny: one intra-op thread a test
    worker runs them faster than a pool contending with the other workers'
    (the thread count is restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@dataclasses.dataclass
class Pair:
    ref_cfg: object
    cfg: object
    ref_params: dict
    model: torch.nn.Module


def make_pair(name: str, seed: int = 0, **overrides) -> Pair:
    """The reference's ``name`` model from ``PRNGKey(seed)`` and the port's
    model holding the same parameters, on the CPU."""
    ref_cfg = dataclasses.replace(ref_arch(name), **overrides)
    cfg = dataclasses.replace(get_arch(name), **overrides)
    params, _ = ref_init(jax.random.PRNGKey(seed), ref_cfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")
    return Pair(ref_cfg, cfg, params, model)


def make_inputs(cfg, b: int = B, s: int = S, seed: int = 0) -> dict:
    """numpy inputs of the family: tokens, and frames or image
    embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = (0.02 * rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model))).astype(np.float32)
    if cfg.family == "vlm":
        out["img_embeds"] = (0.02 * rng.standard_normal(
            (b, cfg.img_tokens, cfg.d_model))).astype(np.float32)
    return out


def ref_run(pair: Pair, inputs: dict, mode=("train", "dense"), states=None):
    logits, states, aux = ref_apply(
        pair.ref_params, pair.ref_cfg,
        {k: jnp.asarray(v) for k, v in inputs.items()}, RefMode(*mode),
        states=states)
    return np.asarray(logits, np.float32), states, float(aux)


def port_run(pair: Pair, inputs: dict, mode=("train", "dense"),
             states=None):
    with torch.no_grad():
        logits, states, aux = model_apply(
            pair.model, pair.cfg,
            {k: torch.as_tensor(v) for k, v in inputs.items()}, Mode(*mode),
            states=states)
    return logits.float().numpy(), states, float(aux)


def prefill_inputs(cfg, inputs: dict, upto: int) -> tuple[dict, dict]:
    """(the prefill of the first ``upto`` tokens, the decode of the next
    one), positions counting the image prefix."""
    b = inputs["tokens"].shape[0]
    prefix = cfg.img_tokens if cfg.family == "vlm" else 0
    pre = dict(inputs)
    pre["tokens"] = inputs["tokens"][:, :upto]
    pre["positions"] = np.broadcast_to(
        np.arange(upto + prefix, dtype=np.int32), (b, upto + prefix)).copy()
    dec = {"tokens": inputs["tokens"][:, upto:upto + 1],
           "positions": np.full((b, 1), upto + prefix, np.int32)}
    return pre, dec


@contextlib.contextmanager
def float32_compute():
    """Both packages' ``COMPUTE_DTYPE`` set to float32 in every module that
    holds the name, for the duration."""
    saved = []
    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] in ("repro", "repro_torch") \
                and ".models" in name and hasattr(mod, "COMPUTE_DTYPE"):
            saved.append((mod, mod.COMPUTE_DTYPE))
            mod.COMPUTE_DTYPE = (jnp.float32 if name.startswith("repro.")
                                 else torch.float32)
    try:
        yield
    finally:
        for mod, value in saved:
            mod.COMPUTE_DTYPE = value


def bf16_tolerance(ref_bf16: np.ndarray, ref_f32: np.ndarray) -> float:
    return max(ATOL_BF16, REF_SHARE * float(np.abs(ref_bf16 - ref_f32).max()))


def check_logits(got: np.ndarray, want: np.ndarray, got_f32, want_f32,
                 vocab: int) -> float:
    """The two bars above on logits (padded vocab columns dropped); returns
    the bfloat16 tolerance."""
    got, want = got[..., :vocab], want[..., :vocab]
    got_f32, want_f32 = got_f32[..., :vocab], want_f32[..., :vocab]
    np.testing.assert_allclose(got_f32, want_f32, atol=ATOL_F32, rtol=0)
    tol = bf16_tolerance(want, want_f32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    ref_err = float(np.abs(want - want_f32).max())
    port_err = float(np.abs(got - want_f32).max())
    assert port_err <= REF_SHARE * ref_err + 1e-3, (port_err, ref_err)
    return tol


def check_greedy(got: np.ndarray, want: np.ndarray, tol: float,
                 vocab: int) -> int:
    """argmax equal wherever the reference's top-2 margin exceeds 2 tol;
    returns how many positions fell under the margin."""
    want = want[..., :vocab]
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * tol
    same = got[..., :vocab].argmax(-1) == want.argmax(-1)
    assert same[clear].all(), f"{int((~same & clear).sum())} clear argmaxes"
    return int((~clear).sum())


def spec_paths(tree, is_leaf) -> dict:
    """{dotted key path: spec as a tuple} of a nested spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(leaf) for path, leaf in flat}


def ref_spec_paths(specs) -> dict:
    return spec_paths(specs, lambda x: isinstance(x, PartitionSpec))


def ref_state(pair: Pair, b: int, buf: int, layout: str = "stacked"):
    return ref_state_init(pair.ref_cfg, b, buf, layout=layout)


def port_state(pair: Pair, b: int, buf: int, layout: str = "stacked"):
    return model_state_init(pair.cfg, b, buf, layout=layout, device="cpu")


# -------------------------------------------------- the per-arch parity tests
# Imported by each family's test module, which defines the ``arch`` fixture
# (an architecture name, "-smoke" configs); ``pair`` is built once a module.

def pair_fixture(request) -> Pair:
    return make_pair(request.param + "-smoke")


def test_forward_matches_reference(pair, record_property):
    inputs = make_inputs(pair.cfg)
    want, _, want_aux = ref_run(pair, inputs)
    got, _, _ = port_run(pair, inputs)
    with float32_compute():
        want32, _, aux32 = ref_run(pair, inputs)
        got32, _, got_aux32 = port_run(pair, inputs)
    tol = check_logits(got, want, got32, want32, pair.cfg.vocab)
    assert abs(got_aux32 - aux32) <= 1e-5 * max(1.0, abs(aux32))
    assert np.isfinite(got).all()
    under = check_greedy(got, want, tol, pair.cfg.vocab)
    record_property("bf16_tolerance", tol)
    record_property("positions_under_margin", under)


def test_decode_matches_reference(pair):
    """The reference's prefill of S - 1 tokens and one decode step against
    the port's, and against the port decoding from the reference's prefill
    state (``convert.lm_state_from_numpy``)."""
    from repro_torch.convert import lm_state_from_numpy

    inputs = make_inputs(pair.cfg)
    pre, dec = prefill_inputs(pair.cfg, inputs, S - 1)
    buf = S + (pair.cfg.img_tokens if pair.cfg.family == "vlm" else 0)
    runs = {}
    for f32 in (False, True):
        with float32_compute() if f32 else contextlib.nullcontext():
            _, st, _ = ref_run(pair, pre, ("prefill", "dense"),
                               ref_state(pair, B, buf))
            want, _, _ = ref_run(pair, dec, ("decode", "dense"), st)
            _, pst, _ = port_run(pair, pre, ("prefill", "dense"),
                                 port_state(pair, B, buf))
            got, _, _ = port_run(pair, dec, ("decode", "dense"), pst)
            carried = lm_state_from_numpy(jax.tree.map(np.asarray, st),
                                          device="cpu")
            from_ref, _, _ = port_run(pair, dec, ("decode", "dense"),
                                      carried)
        runs[f32] = want, got, from_ref
    want, got, from_ref = runs[False]
    want32, got32, from_ref32 = runs[True]
    check_logits(got, want, got32, want32, pair.cfg.vocab)
    check_logits(from_ref, want, from_ref32, want32, pair.cfg.vocab)


def test_decode_matches_full_forward(pair):
    """The port's own property (tests/test_models_smoke.py): the decode
    logits at the last position equal the full forward's (MoE at capacity
    factor 8, so that no token is dropped in either)."""
    cfg = (dataclasses.replace(pair.cfg, capacity_factor=8.0)
           if pair.cfg.n_experts else pair.cfg)
    p = Pair(None, cfg, None, pair.model)
    inputs = make_inputs(cfg)
    full, _, _ = port_run(p, inputs)
    pre, dec = prefill_inputs(cfg, inputs, S - 1)
    buf = S + (cfg.img_tokens if cfg.family == "vlm" else 0)
    _, st, _ = port_run(p, pre, ("prefill", "dense"), port_state(p, B, buf))
    logits, _, _ = port_run(p, dec, ("decode", "dense"), st)
    np.testing.assert_allclose(logits[:, 0], full[:, -1], atol=2e-2,
                               rtol=2e-2)


def test_spec_tree_mirrors_reference(pair):
    """``model_init``'s spec tree has the reference's key paths and specs,
    and its parameters (made on ``meta``: no values) the reference's
    count. Their shapes are checked as ``pair`` loads them."""
    from repro_torch.models import model_init
    from repro_torch.models.layers.common import P

    model, specs = model_init(None, pair.cfg, device="meta")
    _, ref_specs = ref_init(jax.random.PRNGKey(0), pair.ref_cfg)
    assert spec_paths(specs, lambda x: isinstance(x, P)) \
        == ref_spec_paths(ref_specs)
    n_ref = sum(int(np.size(x)) for x in jax.tree.leaves(pair.ref_params))
    assert sum(p.numel() for p in model.parameters()) == n_ref


def test_params_round_trip(pair):
    """reference tree -> port -> tree: every leaf back unchanged."""
    from repro_torch.convert import lm_params_to_numpy

    tree = jax.tree.map(np.asarray, pair.ref_params)
    back = lm_params_to_numpy(pair.model)
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and np.array_equal(a, b)
