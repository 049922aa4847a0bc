#!/usr/bin/env python3
"""How far decoding drifts from the full forward at tinyllama-1.1b's full
depth, in both packages, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_decode_drift.py [--seq 64]

tests/test_models_smoke.py holds the last decode step's logits within
atol = rtol = 2e-2 of the full forward's on 2-layer reduced configs. This
script measures the same gap on the full config (22 layers, d_model
2,048; parameters from ``jax.random.PRNGKey(0)``, carried into the port by
``convert.lm_params_from_numpy``; 2 rows of numpy-seeded tokens): for the
reference and the port, in bfloat16 compute (the configs as they are) and
with every module's ``COMPUTE_DTYPE`` set to float32. Prints one line a
(package, compute) pair: the largest gap, the largest excess over
2e-2 + 2e-2 |logit|, and whether the 2e-2 bar holds. ``--seq 512`` is
chip_smoke.py's length: its bfloat16 decode bar is 1.5 x the reference's
gap there. Takes about a minute at 64 tokens, several at 512, and
~10-13 GB of host memory.
"""
from __future__ import annotations

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as ref_arch
from repro.models import (
    Mode as RefMode, model_apply as ref_apply, model_init as ref_init,
    model_state_init as ref_state_init,
)
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import Mode, model_apply, model_state_init


def set_compute_dtype(f32: bool) -> None:
    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] in ("repro", "repro_torch") \
                and ".models" in name and hasattr(mod, "COMPUTE_DTYPE"):
            jax_pkg = name.startswith("repro.")
            mod.COMPUTE_DTYPE = (
                (jnp.float32 if f32 else jnp.bfloat16) if jax_pkg
                else (torch.float32 if f32 else torch.bfloat16))


def reference_gap(params, cfg, toks):
    s = toks.shape[1]
    full, _, _ = ref_apply(params, cfg, {"tokens": jnp.asarray(toks)},
                           RefMode("train", "dense"))
    st = ref_state_init(cfg, 2, s)
    pre = {"tokens": jnp.asarray(toks[:, :-1]),
           "positions": jnp.broadcast_to(jnp.arange(s - 1)[None], (2, s - 1))}
    _, st, _ = ref_apply(params, cfg, pre, RefMode("prefill", "dense"), st)
    dec = {"tokens": jnp.asarray(toks[:, -1:]),
           "positions": jnp.full((2, 1), s - 1, jnp.int32)}
    last, _, _ = ref_apply(params, cfg, dec, RefMode("decode", "dense"), st)
    return np.asarray(last[:, 0], np.float32), np.asarray(full[:, -1],
                                                          np.float32)


@torch.inference_mode()
def port_gap(model, cfg, toks):
    s = toks.shape[1]
    t = torch.from_numpy(toks)
    full, _, _ = model_apply(model, cfg, {"tokens": t},
                             Mode("train", "dense"))
    st = model_state_init(cfg, 2, s, device="cpu")
    pre = {"tokens": t[:, :-1], "positions": torch.arange(s - 1)[None]}
    _, st, _ = model_apply(model, cfg, pre, Mode("prefill", "dense"), st)
    dec = {"tokens": t[:, -1:], "positions": torch.full((2, 1), s - 1)}
    last, _, _ = model_apply(model, cfg, dec, Mode("decode", "dense"), st)
    return last[:, 0].float().numpy(), full[:, -1].float().numpy()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args()
    name = "tinyllama-1.1b"
    rcfg, cfg = ref_arch(name), get_arch(name)
    params, _ = ref_init(jax.random.PRNGKey(0), rcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, args.seq)).astype(np.int32)
    for f32 in (False, True):
        set_compute_dtype(f32)
        for pkg, gap in (("reference", lambda: reference_gap(params, rcfg,
                                                              toks)),
                         ("port", lambda: port_gap(model, cfg, toks))):
            last, full = (x[:, :cfg.vocab] for x in gap())
            err = np.abs(last - full)
            excess = float(np.max(err - (2e-2 + 2e-2 * np.abs(full))))
            print(f"{pkg:9s} {'float32' if f32 else 'bfloat16':8s} "
                  f"layers {cfg.n_layers} seq {args.seq}: max gap "
                  f"{err.max():.6g}, excess over 2e-2 {excess:.6g}, "
                  f"max |logit| {np.abs(full).max():.4g}, 2e-2 bar "
                  f"{'holds' if excess <= 0 else 'missed'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
