"""GQA attention with RoPE (port of ``repro/models/layers/attention.py``):
dense, blockwise (long-context) and decode paths, over a full or
ring-buffer (sliding-window) KV cache.

Attention is the reference's plain formula in plain torch ops: logits in
float32 (the reference's ``preferred_element_type``), masked slots at
-1e30, a softmax, and the probabilities cast back to the compute type for
the value product. The blockwise path is the reference's online softmax,
its ``lax.scan`` over KV chunks a Python loop. Like the reference it
skips no causal chunk.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers.common import (
    COMPUTE_DTYPE, Dense, Init, Module, P, apply_dense,
)


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_buf, K, Dh), RoPE already applied
    v: torch.Tensor       # (B, S_buf, K, Dh)
    pos: torch.Tensor     # (B, S_buf) absolute positions, -1 = empty
    length: torch.Tensor  # (B,) int32: tokens seen so far per row (rows
    #                       may sit at different positions under
    #                       continuous batching, repro_torch.serve.batching)


def init_cache(batch: int, buf: int, n_kv: int, head_dim: int,
               dtype=COMPUTE_DTYPE, device=None) -> KVCache:
    z = torch.zeros((batch, buf, n_kv, head_dim), dtype=dtype, device=device)
    return KVCache(k=z, v=z.clone(),
                   pos=torch.full((batch, buf), -1, dtype=torch.int32,
                                  device=device),
                   length=torch.zeros((batch,), dtype=torch.int32,
                                      device=device))


def cache_specs(data_axes=("pod", "data")) -> KVCache:
    """Flash-decode layout: the cache shards over the sequence dim on
    "model" (KV heads are few and rarely divide the model axis)."""
    d = tuple(data_axes)
    return KVCache(k=P(d, "model", None, None), v=P(d, "model", None, None),
                   pos=P(d, "model"), length=P(d))


# ------------------------------------------------------------------- rope
def rotate(x: torch.Tensor, positions: torch.Tensor,
           theta: float = 10000.0) -> torch.Tensor:
    """RoPE computed from positions in float32 (no table).
    x: (B, S, H, Dh); positions: (B, S)."""
    dh = x.shape[-1]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float32,
                                  device=x.device) / dh)
    ang = positions.float()[..., None] * inv                 # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- params
class Attention(Module):
    """``{"q", "k", "v", "o"}`` projections (q, k, v biased with
    ``qkv_bias``)."""

    def __init__(self, init: Init, d_model: int, n_heads: int, n_kv: int,
                 head_dim: int, qkv_bias: bool = False):
        super().__init__()
        b = P("model") if qkv_bias else None
        self.q = Dense(init, d_model, n_heads * head_dim, P(None, "model"), b)
        self.k = Dense(init, d_model, n_kv * head_dim, P(None, "model"), b)
        self.v = Dense(init, d_model, n_kv * head_dim, P(None, "model"), b)
        self.o = Dense(init, n_heads * head_dim, d_model, P("model", None))

    def forward(self, *args, **kwargs):
        return attn_apply(self, *args, **kwargs)


# ------------------------------------------------------------- dense path
def _mask(pos_q, pos_k, window, causal=True):
    """(..., Sq, Sk) visibility: causal, sliding window, empty slots (-1)
    excluded."""
    m = pos_k[..., None, :] >= 0
    if causal:
        m = m & (pos_k[..., None, :] <= pos_q[..., :, None])
    if window is not None:
        m = m & (pos_q[..., :, None] - pos_k[..., None, :] < window)
    return m


def _sdpa(q, k, v, mask):
    """q: (B, Sq, K, G, Dh); k, v: (B, Sk, K, Dh); mask: (B, Sq, Sk)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def blockwise_attention(q, k, v, pos_q, pos_k, *, window=None,
                        q_chunk: int = 1024, kv_chunk: int = 1024):
    """Online-softmax attention, O(Sq * kv_chunk) live logits; shapes as
    ``_sdpa``."""
    b, sq, kh, g, dh = q.shape
    sk = k.shape[1]
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) must divide the "
                         f"lengths ({sq}, {sk})")
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for q0 in range(0, sq, q_chunk):
        qc, pqc = q[:, q0:q0 + q_chunk], pos_q[:, q0:q0 + q_chunk]
        qf = qc.float()
        m = torch.full((b, kh, g, q_chunk), -math.inf, device=q.device)
        l = torch.zeros((b, kh, g, q_chunk), device=q.device)
        acc = torch.zeros((b, kh, g, q_chunk, dh), device=q.device)
        for k0 in range(0, sk, kv_chunk):
            kc, vc = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            logits = torch.einsum("bqkgd,bskd->bkgqs", qf, kc.float()) * scale
            mask = _mask(pqc, pos_k[:, k0:k0 + kv_chunk], window)
            logits = logits.masked_fill(~mask[:, None, None], -1e30)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(q.dtype), vc).float()
            m = m_new
        out = (acc / l[..., None].clamp_min(1e-30)).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))             # (B, qc, K, G, Dh)
    return torch.cat(outs, dim=1)


# ------------------------------------------------------------- public API
def attn_apply(
    p: Attention, x: torch.Tensor, positions: torch.Tensor, *,
    n_heads: int, n_kv: int, head_dim: int, theta: float = 10000.0,
    window: Optional[int] = None, impl: str = "dense",
    q_chunk: int = 1024, kv_chunk: int = 1024,
    cache: Optional[KVCache] = None, rope: bool = True, causal: bool = True,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """-> (out (B, S, D), the updated cache or None).

    Train: no cache. Prefill: a cache, S > 1: attend within the sequence
    and persist its last min(S, buf) tokens. Decode: S = 1 and a cache:
    write the token into each row's ring slot, then attend over the cache.
    The given cache is not modified; a new one is returned.
    """
    b, s, _ = x.shape
    g = n_heads // n_kv
    q = apply_dense(p.q, x).reshape(b, s, n_kv, g, head_dim)
    k = apply_dense(p.k, x).reshape(b, s, n_kv, head_dim)
    v = apply_dense(p.v, x).reshape(b, s, n_kv, head_dim)
    if rope:
        q = rotate(q.reshape(b, s, n_heads, head_dim), positions, theta
                   ).reshape(b, s, n_kv, g, head_dim)
        k = rotate(k, positions, theta)

    pos_q = positions.expand(b, s).to(torch.int32)
    if cache is not None and s == 1:
        # decode: one token per row into slot length % buf (rows may sit at
        # different lengths under continuous batching)
        buf = cache.k.shape[1]
        at = (torch.arange(b, device=x.device), (cache.length % buf).long())
        cache = KVCache(cache.k.index_put(at, k[:, 0]),
                        cache.v.index_put(at, v[:, 0]),
                        cache.pos.index_put(at, pos_q[:, 0]),
                        cache.length + 1)
        out = _sdpa(q, cache.k, cache.v, _mask(pos_q, cache.pos, window))
    else:
        if impl == "blockwise":
            out = blockwise_attention(q, k, v, pos_q, pos_q, window=window,
                                      q_chunk=q_chunk, kv_chunk=kv_chunk)
        else:
            out = _sdpa(q, k, v, _mask(pos_q, pos_q, window, causal))
        if cache is not None:
            # prefill: the ring is position-keyed (position t -> slot
            # t % buf), so the last min(S, buf) tokens are rolled into place
            # and the decode write pointer length % buf hits the oldest slot
            buf = cache.k.shape[1]
            tail = min(s, buf)
            shift = (s - tail) % buf

            def put(dst, src):
                dst = dst.clone()
                dst[:, :tail] = torch.roll(src[:, s - tail:], shift, dims=1)
                return dst

            cache = KVCache(put(cache.k, k), put(cache.v, v),
                            put(cache.pos, pos_q), cache.length + s)
    out = out.reshape(b, s, n_heads * head_dim)
    return apply_dense(p.o, out), cache
