"""Family dispatcher (port of ``repro/models/api.py``): one (init, apply,
state) API over all ten architectures.

Inputs per family:
  decoder LMs : tokens (B, S) int
  audio       : tokens (B, S) + frames (B, enc_seq, d_model) float32 (stub)
  vlm         : tokens (B, S - img_tokens) + img_embeds (B, img_tokens, d)

Parameters, states and inputs are made on ``device`` (None means the card,
and a missing card raises) from an explicit ``torch.Generator`` (None
means one on that device seeded with 0). ``jax.random`` cannot be
reproduced in torch, so the same seed draws other values than the
reference; ``repro_torch.convert.lm_params_from_numpy`` carries the
reference's parameters in.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import encdec, lm
from repro_torch.models.blocks import Mode
from repro_torch.models.layers.common import P
from repro_torch.solver.engine import resolve_device


def pick_mode(cfg: ArchConfig, shape_kind: str, seq: int) -> Mode:
    """Blockwise (online-softmax) attention for non-decode work past
    8,192 tokens, which bounds the live logits to O(S * chunk); dense
    below, as the reference chooses."""
    impl = "blockwise" if seq > 8192 and shape_kind != "decode" else "dense"
    return Mode(kind=shape_kind, attn_impl=impl)


def model_init(generator: Optional[torch.Generator], cfg: ArchConfig, *,
               device=None):
    """-> (parameters as an ``nn.Module``, their spec tree)."""
    if cfg.family == "audio":
        return encdec.encdec_init(generator, cfg, device)
    return lm.lm_init(generator, cfg, device)


def model_apply(params, cfg: ArchConfig, inputs: dict, mode: Mode,
                states=None):
    """-> (logits, new states, aux)."""
    tokens = inputs["tokens"]
    b, s_tok = tokens.shape
    dev = tokens.device
    if cfg.family == "audio":
        positions = inputs.get("positions")
        if positions is None:
            positions = torch.arange(s_tok, device=dev)[None].expand(b, s_tok)
        return encdec.encdec_apply(
            params, cfg, tokens, positions, mode,
            frames=inputs.get("frames"), state=states)
    prefix = inputs.get("img_embeds")
    s_total = s_tok + (prefix.shape[1] if prefix is not None else 0)
    positions = inputs.get("positions")
    if positions is None:
        positions = torch.arange(s_total, device=dev)[None].expand(
            b, s_total)
    return lm.lm_apply(params, cfg, tokens, positions, mode,
                       states=states, prefix_embeds=prefix)


def model_state_init(cfg: ArchConfig, batch: int, buf: int,
                     layout: str = "stacked", device=None):
    device = resolve_device(device)
    if cfg.family == "audio":
        return encdec.init_encdec_state(cfg, batch, buf, device)
    return lm.init_lm_state(cfg, batch, buf, layout=layout, device=device)


def model_state_specs(cfg: ArchConfig, data_axes=("pod", "data"),
                      layout: str = "stacked"):
    if cfg.family == "audio":
        return encdec.encdec_state_specs(cfg, data_axes)
    return lm.lm_state_specs(cfg, data_axes, layout=layout)


def make_inputs(cfg: ArchConfig, shape: ShapeConfig, *,
                as_specs: bool = False,
                generator: Optional[torch.Generator] = None,
                device=None) -> dict[str, Any]:
    """Drawn inputs, or with ``as_specs`` tensors on the ``meta`` device
    that carry only shapes and dtypes."""
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    toks_s = s
    extras = {}
    if cfg.family == "vlm" and shape.kind != "decode":
        toks_s = max(s - cfg.img_tokens, 1)
        extras["img_embeds"] = (b, cfg.img_tokens, cfg.d_model)
    if cfg.family == "audio" and shape.kind != "decode":
        extras["frames"] = (b, cfg.enc_seq, cfg.d_model)
    out: dict[str, Any] = {}
    if as_specs:
        meta = torch.device("meta")
        out["tokens"] = torch.empty((b, toks_s), dtype=torch.int32,
                                    device=meta)
        for name, shp in extras.items():
            out[name] = torch.empty(shp, device=meta)
    else:
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        out["tokens"] = torch.randint(0, cfg.vocab, (b, toks_s),
                                      generator=generator, device=dev,
                                      dtype=torch.int32)
        for name, shp in extras.items():
            out[name] = torch.randn(shp, generator=generator,
                                    device=dev) * 0.02
    if shape.kind == "decode":
        dev = torch.device("meta") if as_specs else out["tokens"].device
        out["positions"] = torch.full((b, 1), shape.seq_len,
                                      dtype=torch.int32, device=dev)
    return out


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    return make_inputs(cfg, shape, as_specs=True)


def input_sharding(cfg: ArchConfig, shape: ShapeConfig,
                   data_axes=("pod", "data")) -> dict:
    d = tuple(data_axes)
    specs = {"tokens": P(d, None)}
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["img_embeds"] = P(d, None, None)
    if cfg.family == "audio" and shape.kind != "decode":
        specs["frames"] = P(d, None, None)
    if shape.kind == "decode":
        specs["positions"] = P(d, None)
    return specs
