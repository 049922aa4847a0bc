"""Residual blocks (port of ``repro/models/blocks.py``): one module class
and one decode-state initialiser per block kind.

Every block: x -> x + f(norm(x)) [-> x + mlp(norm(x)) where the kind has a
separate FFN]. ``forward(cfg, x, positions, state, mode)`` returns
``(x, new_state, aux)`` so MoE aux losses and recurrent / KV state thread
uniformly through the layer loop of ``models/lm.py``. The config is an
argument of ``forward``, as in the reference, not stored in the module.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import xlstm as xl
from repro_torch.models.layers.attention import Attention, init_cache
from repro_torch.models.layers.common import (
    COMPUTE_DTYPE, Init, Module, norm_class,
)
from repro_torch.models.layers.mlp import mlp_class
from repro_torch.models.layers.moe import MoE
from repro_torch.models.layers.rglru import (
    RGLRU, init_rglru_state, rglru_block_apply,
)


class Mode(NamedTuple):
    kind: str                 # "train" | "prefill" | "decode"
    attn_impl: str            # "dense" | "blockwise"
    q_chunk: int = 1024
    kv_chunk: int = 1024


def remat_units(mode: Mode) -> bool:
    """Train mode under autograd: the layer loops keep each unit's input
    and recompute its activations in backward
    (``torch.utils.checkpoint``), as the reference wraps its scan bodies
    in ``jax.checkpoint(policy=nothing_saveable)``. Serving runs under
    ``inference_mode`` and never recomputes."""
    return mode.kind == "train" and torch.is_grad_enabled()


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _attention(cfg: ArchConfig, init: Init) -> Attention:
    return Attention(init, cfg.d_model, cfg.n_heads, cfg.n_kv,
                     cfg.resolved_head_dim, cfg.qkv_bias)


def _attend(p: Attention, cfg: ArchConfig, x, positions, state, mode: Mode):
    return p(x, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
             head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta,
             window=cfg.window, impl=mode.attn_impl, q_chunk=mode.q_chunk,
             kv_chunk=mode.kv_chunk, cache=state)


class AttnBlock(Module):
    def __init__(self, init: Init, cfg: ArchConfig):
        super().__init__()
        self.attn = _attention(cfg, init)
        self.mlp = mlp_class(cfg)(init, cfg.d_model, cfg.d_ff)
        self.norm1 = norm_class(cfg)(init, cfg.d_model)
        self.norm2 = norm_class(cfg)(init, cfg.d_model)

    def forward(self, cfg: ArchConfig, x, positions, state, mode: Mode):
        h, new_state = _attend(self.attn, cfg, self.norm1(x), positions,
                               state, mode)
        x = x + h
        x = x + self.mlp(self.norm2(x))
        return x, new_state, _no_aux(x)


class MoEBlock(Module):
    def __init__(self, init: Init, cfg: ArchConfig):
        super().__init__()
        self.attn = _attention(cfg, init)
        self.moe = MoE(init, cfg.d_model, cfg.d_ff, cfg.n_experts)
        self.norm1 = norm_class(cfg)(init, cfg.d_model)
        self.norm2 = norm_class(cfg)(init, cfg.d_model)

    def forward(self, cfg: ArchConfig, x, positions, state, mode: Mode):
        h, new_state = _attend(self.attn, cfg, self.norm1(x), positions,
                               state, mode)
        x = x + h
        out = self.moe(self.norm2(x), top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor)
        return x + out.y, new_state, out.aux_loss


class RecBlock(Module):
    def __init__(self, init: Init, cfg: ArchConfig):
        super().__init__()
        self.rec = RGLRU(init, cfg.d_model, cfg.resolved_d_rnn)
        self.mlp = mlp_class(cfg)(init, cfg.d_model, cfg.d_ff)
        self.norm1 = norm_class(cfg)(init, cfg.d_model)
        self.norm2 = norm_class(cfg)(init, cfg.d_model)

    def forward(self, cfg: ArchConfig, x, positions, state, mode: Mode):
        h, new_state = rglru_block_apply(self.rec, self.norm1(x), state)
        x = x + h
        x = x + self.mlp(self.norm2(x))
        return x, new_state, _no_aux(x)


class MLSTMBlock(Module):
    def __init__(self, init: Init, cfg: ArchConfig):
        super().__init__()
        self.cell = xl.MLSTM(init, cfg.d_model, cfg.n_heads)
        self.norm1 = norm_class(cfg)(init, cfg.d_model)

    def forward(self, cfg: ArchConfig, x, positions, state, mode: Mode):
        h, new_state = xl.mlstm_block_apply(
            self.cell, self.norm1(x), state, n_heads=cfg.n_heads,
            chunk=cfg.mlstm_chunk)
        return x + h, new_state, _no_aux(x)


class SLSTMBlock(Module):
    def __init__(self, init: Init, cfg: ArchConfig):
        super().__init__()
        self.cell = xl.SLSTM(init, cfg.d_model, cfg.n_heads)
        self.norm1 = norm_class(cfg)(init, cfg.d_model)

    def forward(self, cfg: ArchConfig, x, positions, state, mode: Mode):
        h, new_state = xl.slstm_block_apply(
            self.cell, self.norm1(x), state, n_heads=cfg.n_heads)
        return x + h, new_state, _no_aux(x)


BLOCKS: dict[str, type] = {
    "attn": AttnBlock,
    "moe": MoEBlock,
    "rec": RecBlock,
    "mlstm": MLSTMBlock,
    "slstm": SLSTMBlock,
}


def init_block_state(kind: str, cfg: ArchConfig, batch: int, buf: int,
                     device=None):
    """Decode-time state of one block of ``kind``; ``buf`` is the KV
    buffer length (already window-clamped by the caller)."""
    dh = cfg.resolved_head_dim
    if kind in ("attn", "moe"):
        return init_cache(batch, buf, cfg.n_kv, dh, COMPUTE_DTYPE, device)
    if kind == "rec":
        return init_rglru_state(batch, cfg.resolved_d_rnn, COMPUTE_DTYPE,
                                device)
    if kind == "mlstm":
        return xl.init_mlstm_state(batch, cfg.n_heads,
                                   cfg.d_model // cfg.n_heads, device)
    if kind == "slstm":
        return xl.init_slstm_state(batch, cfg.n_heads,
                                   cfg.d_model // cfg.n_heads, device)
    raise ValueError(kind)
