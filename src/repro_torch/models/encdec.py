"""Whisper-style encoder-decoder backbone (port of
``repro/models/encdec.py``).

The conv frontend is a stub: the caller supplies frame embeddings
(B, enc_seq, d_model). Positions are sinusoidal, computed rather than
tabled. Decoder layers: causal self-attention (KV cache), cross-attention
over the encoder states (K/V cached at prefill) and a GELU MLP,
pre-LayerNorm with biased projections. The reference's scans over encoder
and decoder layers are Python loops; its encoder passes no ``causal``
flag to attention, so its self-attention is causal, and so is this one.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import Mode, remat_units
from repro_torch.models.layers.attention import (
    Attention, _sdpa, attn_apply, cache_specs, init_cache,
)
from repro_torch.models.layers.common import (
    COMPUTE_DTYPE, Embedding, Init, LayerNorm, Module, P, apply_dense,
    apply_embedding, param_specs, tree_map, unembed,
)
from repro_torch.models.layers.mlp import GeluMLP


class EncDecState(NamedTuple):
    self_cache: Any        # KVCache stacked over decoder layers
    cross_k: torch.Tensor  # (L, B, enc_seq, K, Dh)
    cross_v: torch.Tensor  # (L, B, enc_seq, K, Dh)


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) -> (B, S, d) sinusoidal embeddings."""
    half = d // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32,
                                   device=positions.device)
                     * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _attention(init: Init, cfg: ArchConfig) -> Attention:
    return Attention(init, cfg.d_model, cfg.n_heads, cfg.n_kv,
                     cfg.resolved_head_dim, qkv_bias=True)


class EncLayer(Module):
    def __init__(self, init: Init, cfg: ArchConfig):
        super().__init__()
        self.attn = _attention(init, cfg)
        self.mlp = GeluMLP(init, cfg.d_model, cfg.d_ff)
        self.norm1 = LayerNorm(init, cfg.d_model)
        self.norm2 = LayerNorm(init, cfg.d_model)


class DecLayer(Module):
    def __init__(self, init: Init, cfg: ArchConfig):
        super().__init__()
        self.self = _attention(init, cfg)   # the reference's key: self-attention
        self.cross = _attention(init, cfg)
        self.mlp = GeluMLP(init, cfg.d_model, cfg.d_ff)
        self.norm1 = LayerNorm(init, cfg.d_model)
        self.norm2 = LayerNorm(init, cfg.d_model)
        self.norm3 = LayerNorm(init, cfg.d_model)


class EncDec(Module):
    def __init__(self, init: Init, cfg: ArchConfig):
        super().__init__()
        self.embed = Embedding(init, cfg.vocab, cfg.d_model)
        self.enc_units = nn.ModuleList(
            [EncLayer(init, cfg) for _ in range(cfg.enc_layers)])
        self.dec_units = nn.ModuleList(
            [DecLayer(init, cfg) for _ in range(cfg.n_layers)])
        self.enc_norm = LayerNorm(init, cfg.d_model)
        self.dec_norm = LayerNorm(init, cfg.d_model)


def encdec_init(generator: Optional[torch.Generator], cfg: ArchConfig,
                device=None) -> tuple[EncDec, dict]:
    model = EncDec(Init(generator, device), cfg)
    return model, param_specs(model)


# ------------------------------------------------------------------ encode
def encode(params: EncDec, cfg: ArchConfig, frames: torch.Tensor,
           mode: Mode) -> torch.Tensor:
    """frames: (B, enc_seq, d_model) stub-frontend embeddings."""
    b, s, _ = frames.shape
    pos = torch.arange(s, device=frames.device)[None].expand(b, s)
    x = frames.to(COMPUTE_DTYPE) + sinusoid(pos, cfg.d_model).to(
        COMPUTE_DTYPE)
    for p in params.enc_units:
        h, _ = attn_apply(p.attn, p.norm1(x), pos, n_heads=cfg.n_heads,
                          n_kv=cfg.n_kv, head_dim=cfg.resolved_head_dim,
                          rope=False, impl="dense")
        x = x + h
        x = x + p.mlp(p.norm2(x))
    return params.enc_norm(x)


def _cross_attend(p: Attention, cfg: ArchConfig, x, ck, cv):
    """Full-visibility cross attention; ck, cv: (B, enc_seq, K, Dh)."""
    b, s, _ = x.shape
    g = cfg.n_heads // cfg.n_kv
    dh = cfg.resolved_head_dim
    q = apply_dense(p.q, x).reshape(b, s, cfg.n_kv, g, dh)
    mask = torch.ones((b, s, ck.shape[1]), dtype=torch.bool, device=x.device)
    out = _sdpa(q, ck, cv, mask).reshape(b, s, cfg.n_heads * dh)
    return apply_dense(p.o, out)


def _cross_kv(p: Attention, cfg: ArchConfig, enc: torch.Tensor):
    b, se, _ = enc.shape
    dh = cfg.resolved_head_dim
    k = apply_dense(p.k, enc).reshape(b, se, cfg.n_kv, dh)
    v = apply_dense(p.v, enc).reshape(b, se, cfg.n_kv, dh)
    return k, v


def _dec_layer(p: DecLayer, cfg: ArchConfig, x, positions, mode: Mode,
               ck, cv, cache):
    """One decoder layer: causal self-attention (over ``cache`` if given),
    cross-attention over (ck, cv), the MLP. -> (x, the new cache)."""
    h, cache = attn_apply(
        p.self, p.norm1(x), positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.resolved_head_dim, rope=False, impl=mode.attn_impl,
        q_chunk=mode.q_chunk, kv_chunk=mode.kv_chunk, cache=cache)
    x = x + h
    x = x + _cross_attend(p.cross, cfg, p.norm2(x), ck, cv)
    return x + p.mlp(p.norm3(x)), cache


def _train_layer_fn(p: DecLayer, cfg: ArchConfig, positions, mode: Mode):
    """A decoder layer without state as a function of (x, enc): what
    train mode recomputes in backward."""
    def run(x, enc):
        ck, cv = _cross_kv(p.cross, cfg, enc)
        return _dec_layer(p, cfg, x, positions, mode, ck, cv, None)[0]
    return run


# ------------------------------------------------------------------ decode
def encdec_apply(
    params: EncDec, cfg: ArchConfig, tokens: torch.Tensor,
    positions: torch.Tensor, mode: Mode,
    frames: Optional[torch.Tensor] = None,
    state: Optional[EncDecState] = None,
) -> tuple[torch.Tensor, Optional[EncDecState], torch.Tensor]:
    """Train: frames, no state (each decoder layer checkpointed under
    autograd, ``remat_units``). Prefill: frames and a state (filled with
    the self caches and the cross K/V). Decode: a state; frames ignored."""
    x = apply_embedding(params.embed, tokens)
    x = x + sinusoid(positions, cfg.d_model).to(x.dtype)
    enc = encode(params, cfg, frames, mode) if frames is not None else None
    have_state = state is not None
    remat = remat_units(mode) and not have_state
    caches, cross = [], []
    for i, p in enumerate(params.dec_units):
        if remat:
            # the reference's jax.checkpoint(nothing_saveable) of its scan
            # body: a layer keeps its inputs, recomputes the rest in backward
            x = checkpoint(_train_layer_fn(p, cfg, positions, mode), x, enc,
                           use_reentrant=False)
            continue
        if have_state and enc is None:     # decode: the cached cross K/V
            ck, cv = state.cross_k[i], state.cross_v[i]
        else:
            ck, cv = _cross_kv(p.cross, cfg, enc)
        cache = (tree_map(lambda t: t[i], state.self_cache)
                 if have_state else None)
        x, cache = _dec_layer(p, cfg, x, positions, mode, ck, cv, cache)
        caches.append(cache)
        cross.append((ck, cv))

    new_state = None
    if have_state:
        stacked = tree_map(lambda *xs: torch.stack(xs), *caches)
        if enc is not None:
            new_state = EncDecState(stacked,
                                    torch.stack([c[0] for c in cross]),
                                    torch.stack([c[1] for c in cross]))
        else:
            new_state = EncDecState(stacked, state.cross_k, state.cross_v)
    x = params.dec_norm(x)
    logits = unembed(params.embed, x, cfg.vocab)
    return logits, new_state, torch.zeros((), device=x.device)


def init_encdec_state(cfg: ArchConfig, batch: int, buf: int,
                      device=None) -> EncDecState:
    dh = cfg.resolved_head_dim
    one = init_cache(batch, buf, cfg.n_kv, dh, COMPUTE_DTYPE, device)
    stacked = tree_map(
        lambda x: x.expand(cfg.n_layers, *x.shape).clone(), one)
    zkv = torch.zeros((cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv, dh),
                      dtype=COMPUTE_DTYPE, device=device)
    return EncDecState(stacked, zkv, zkv.clone())


def encdec_state_specs(cfg: ArchConfig, data_axes=("pod", "data")):
    d = tuple(data_axes)
    cs = tree_map(lambda s: P(None, *s), cache_specs(data_axes),
                  is_leaf=lambda s: isinstance(s, P))
    kv = P(None, d, "model", None, None)   # sequence-sharded (flash-decode)
    return EncDecState(cs, kv, kv)

