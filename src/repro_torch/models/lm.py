"""Decoder-only LM assembled from the block registry (port of
``repro/models/lm.py``).

Layers are grouped into repeating pattern units (dense: ("attn",);
Griffin: ("rec", "rec", "attn"); xLSTM: 7 mlstm + 1 slstm). The reference
stacks each pattern slot's parameters on a leading unit axis and runs one
``lax.scan`` over units; here each slot is a ``ModuleList`` of the units'
blocks and the scan is a Python loop over layers, in the same order.
Remainder layers (n_layers % |pattern|) follow, in ``rest``.

``prefix_embeds`` carries stub-frontend modalities (VLM patch
embeddings); the token embeddings are concatenated after it.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import (
    BLOCKS, Mode, init_block_state, remat_units,
)
from repro_torch.models.layers import xlstm as xl
from repro_torch.models.layers.attention import cache_specs
from repro_torch.models.layers.common import (
    Embedding, Init, Module, P, apply_embedding, norm_class, param_specs,
    tree_map, unembed,
)
from repro_torch.models.layers.rglru import rglru_state_specs


def _unit_layout(cfg: ArchConfig) -> tuple[int, list[str], list[str]]:
    pat = list(cfg.pattern)
    n_units = cfg.n_layers // len(pat)
    rest = cfg.layer_kinds()[n_units * len(pat):]
    return n_units, pat, rest


class LM(Module):
    """``embed``, ``units`` (slot key -> one block a unit), ``rest``,
    ``final_norm`` and, untied, ``lm_head``: the reference's tree."""

    def __init__(self, init: Init, cfg: ArchConfig):
        super().__init__()
        n_units, pat, rest = _unit_layout(cfg)
        self.embed = Embedding(init, cfg.vocab, cfg.d_model)
        self.units = nn.ModuleDict({
            f"{i}_{kind}": nn.ModuleList(
                [BLOCKS[kind](init, cfg) for _ in range(n_units)])
            for i, kind in enumerate(pat)})
        self.rest = nn.ModuleDict({
            f"{i}_{kind}": BLOCKS[kind](init, cfg)
            for i, kind in enumerate(rest)})
        self.final_norm = norm_class(cfg)(init, cfg.d_model)
        if not cfg.tied_embeddings:
            self.lm_head = Embedding(init, cfg.vocab, cfg.d_model)


def lm_init(generator: Optional[torch.Generator], cfg: ArchConfig,
            device=None) -> tuple[LM, dict]:
    model = LM(Init(generator, device), cfg)
    return model, param_specs(model)


# ----------------------------------------------------------- decode state
def init_lm_state(cfg: ArchConfig, batch: int, buf: int,
                  layout: str = "stacked", device=None):
    """Per-layer decode state; KV buffers are clamped to the attention
    window (a ring buffer), so windowed archs keep bounded state.

    layout="stacked": one leading unit axis per slot (the reference's scan
    layout). layout="list": one state a unit, as the serving engine uses."""
    n_units, pat, rest = _unit_layout(cfg)
    kv_buf = min(buf, cfg.window) if cfg.window else buf

    def one(kind):
        return init_block_state(kind, cfg, batch,
                                kv_buf if kind in ("attn", "moe") else buf,
                                device)

    if layout == "list":
        units = {f"{i}_{kind}": [one(kind) for _ in range(n_units)]
                 for i, kind in enumerate(pat)}
    else:
        units = {f"{i}_{kind}": tree_map(
            lambda x: x.expand(n_units, *x.shape).clone(), one(kind))
            for i, kind in enumerate(pat)}
    rest_s = {f"{i}_{kind}": one(kind) for i, kind in enumerate(rest)}
    return {"units": units, "rest": rest_s}


def lm_state_specs(cfg: ArchConfig, data_axes=("pod", "data"),
                   layout: str = "stacked"):
    d = tuple(data_axes)

    def one(kind):
        if kind in ("attn", "moe"):
            return cache_specs(data_axes)
        if kind == "rec":
            return rglru_state_specs(data_axes)
        if kind == "mlstm":
            # NH is small (4): shard the Dh dims, not heads
            return xl.MLSTMState(c=P(d, None, "model", None),
                                 n=P(d, None, "model"), m=P(d, None))
        return xl.SLSTMState(c=P(d, None, "model"), n=P(d, None, "model"),
                             h=P(d, None, "model"), m=P(d, None, "model"))

    def lift(spec):  # the leading unit axis
        return tree_map(lambda s: P(None, *s), spec,
                        is_leaf=lambda s: isinstance(s, P))

    n_units, pat, rest = _unit_layout(cfg)
    if layout == "list":
        units = {f"{i}_{kind}": [one(kind) for _ in range(n_units)]
                 for i, kind in enumerate(pat)}
    else:
        units = {f"{i}_{kind}": lift(one(kind)) for i, kind in enumerate(pat)}
    rest_s = {f"{i}_{kind}": one(kind) for i, kind in enumerate(rest)}
    return {"units": units, "rest": rest_s}


# ------------------------------------------------------------------ apply
def _unit_fn(params: LM, cfg: ArchConfig, pat: list[str], i: int,
             positions: torch.Tensor, mode: Mode):
    """Unit ``i`` (every slot of the pattern) as a function of (x, aux),
    without decode state: what train mode recomputes in backward."""
    def run(x, aux):
        for j, kind in enumerate(pat):
            x, _, a = params.units[f"{j}_{kind}"][i](cfg, x, positions, None,
                                                     mode)
            aux = aux + a
        return x, aux
    return run


def lm_apply(
    params: LM, cfg: ArchConfig, tokens: torch.Tensor,
    positions: torch.Tensor, mode: Mode, states=None, prefix_embeds=None,
) -> tuple[torch.Tensor, Any, torch.Tensor]:
    """tokens (B, S_tok) int; positions (B, S_total).

    -> (logits (B, S_total, vocab_padded) float32, new states or None,
    aux loss). The given states are not modified. In train mode under
    autograd each pattern unit is checkpointed (``remat_units``)."""
    n_units, pat, rest = _unit_layout(cfg)
    x = apply_embedding(params.embed, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)

    have_state = states is not None
    list_layout = have_state and bool(states["units"]) and isinstance(
        next(iter(states["units"].values())), list)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_units = {key: [] for key in params.units}
    remat = remat_units(mode) and not have_state
    for i in range(n_units):
        if remat:
            # the reference's jax.checkpoint(nothing_saveable) of its scan
            # body: a unit keeps its input and recomputes the rest in backward
            x, aux = checkpoint(_unit_fn(params, cfg, pat, i, positions, mode),
                                x, aux, use_reentrant=False)
            continue
        for j, kind in enumerate(pat):
            key = f"{j}_{kind}"
            st = None
            if list_layout:
                st = states["units"][key][i]
            elif have_state:
                st = tree_map(lambda t: t[i], states["units"][key])
            x, st, a = params.units[key][i](cfg, x, positions, st, mode)
            new_units[key].append(st)
            aux = aux + a
    new_rest = {}
    for i, kind in enumerate(rest):
        key = f"{i}_{kind}"
        st = states["rest"][key] if have_state else None
        x, new_rest[key], a = params.rest[key](cfg, x, positions, st,
                                               mode)
        aux = aux + a

    x = params.final_norm(x)
    head = params.lm_head if hasattr(params, "lm_head") else params.embed
    logits = unembed(head, x, cfg.vocab)
    if not have_state:
        return logits, None, aux
    if not list_layout:
        new_units = {key: tree_map(lambda *xs: torch.stack(xs), *sts)
                     for key, sts in new_units.items()}
    return logits, {"units": new_units, "rest": new_rest}, aux
