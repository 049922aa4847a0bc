"""A dense decoder-only transformer in plain float32 PyTorch: the weights
the benchmark draws for both sides, and the reference forward pass.

The configuration's file gives the sizes under the Hugging Face names
(``hidden_size``, ``num_hidden_layers``, ``num_attention_heads``,
``num_key_value_heads``, ``head_dim``, ``intermediate_size``,
``vocab_size``, ``rope_theta``, ``rms_norm_eps``, ``qkv_bias``,
``tie_word_embeddings``). The block, as Qwen2 publishes it:

    h = RMSNorm(x) * g1
    q, k, v = h Wq + bq, h Wk + bk, h Wv + bv        (biases with qkv_bias)
    q, k = RoPE(q), RoPE(k)   rotate-half, inv_freq theta^(-2i / head_dim)
    query head j reads key/value head j // (heads / kv_heads)
    a = softmax(q k^T / sqrt(head_dim), keys 0..t) v   (causal)
    x = x + a Wo
    h = RMSNorm(x) * g2
    x = x + (silu(h Wg) * (h Wu)) Wd

then a final RMSNorm and the output head (the embedding when tied):
logits = RMSNorm(x) * g W_head^T. RMSNorm(x) = x / sqrt(mean(x^2) + eps).

Everything is float32 with TF32 off; the RoPE angles are taken in
float64 and rounded once. ``mm`` is every matrix product of the pass (the
attention's two included), so the control can round their inputs
(``precision.e4m3``). Plain PyTorch only: it imports nothing of the port,
of ``repro`` or of JAX.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch

#: the block this module computes, as the serving program checks it
#: against the port's architecture (its layers' kinds: ``layer_kinds``)
BLOCK = {"family": "dense", "norm": "rms", "mlp": "swiglu", "window": None}
#: configuration key -> the port's ArchConfig field (``arch_fields``)
FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
          "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv",
          "head_dim": "head_dim", "intermediate_size": "d_ff",
          "vocab_size": "vocab", "rope_theta": "rope_theta",
          "qkv_bias": "qkv_bias", "tie_word_embeddings": "tied_embeddings"}
#: the CPU tests' cut of a configuration of this block (``_tiny``): the
#: port's CPU-smoke widths (``ArchConfig.reduced``) and two layers; two
#: inputs (2 prompts of 16 tokens, 3 of 8) over a vocabulary of 256, and
#: 4 new tokens
SMOKE = {
    "config": {"hidden_size": 64, "num_hidden_layers": 2,
               "num_attention_heads": 4, "num_key_value_heads": 2,
               "head_dim": 16, "intermediate_size": 128, "vocab_size": 256},
    "data": {"vocab": 256,
             "per_input": [{"batch": 2, "prompt_len": 16},
                           {"batch": 3, "prompt_len": 8}]},
    "mix": {"generate": {"steps": 4}}}
#: the per-layer weights, each stacked on a leading layer axis under
#: ``layers.<name>``; the names are the block's own parameter paths
LAYER = ("attn.q.w", "attn.q.b", "attn.k.w", "attn.k.b", "attn.v.w",
         "attn.v.b", "attn.o.w", "mlp.gate.w", "mlp.up.w", "mlp.down.w",
         "norm1.scale", "norm2.scale")
EMBED_STD = 0.02       # embedding and head rows
BIAS_STD = 0.1         # q, k, v biases
NORM_STD = 0.1         # RMSNorm gains, about 1


def arch_fields(c: dict) -> dict:
    """The port's ArchConfig fields that configuration ``c`` sets."""
    return {f: c[k] for k, f in FIELDS.items()}


def layer_kinds(c: dict) -> list:
    """The port's block kind of each layer, at the configuration's
    depth."""
    return ["attn"] * c["num_hidden_layers"]


def sizes(c: dict) -> dict:
    return {"d": c["hidden_size"], "layers": c["num_hidden_layers"],
            "heads": c["num_attention_heads"],
            "kv": c["num_key_value_heads"], "dh": c["head_dim"],
            "ff": c["intermediate_size"], "vocab": c["vocab_size"]}


def layout(c: dict) -> dict:
    """Weight name -> (shape, mean, std) of its draw, in draw order."""
    s = sizes(c)
    d, n, dq, dkv, ff = (s["d"], s["layers"], s["heads"] * s["dh"],
                         s["kv"] * s["dh"], s["ff"])
    out = {"embed.embedding": ((s["vocab"], d), 0.0, EMBED_STD)}
    if not c["tie_word_embeddings"]:
        out["lm_head.embedding"] = ((s["vocab"], d), 0.0, EMBED_STD)
    out["final_norm.scale"] = ((d,), 1.0, NORM_STD)
    mats = {"attn.q.w": (d, dq), "attn.k.w": (d, dkv), "attn.v.w": (d, dkv),
            "attn.o.w": (dq, d), "mlp.gate.w": (d, ff), "mlp.up.w": (d, ff),
            "mlp.down.w": (ff, d)}
    for name in LAYER:
        if name in mats:
            fan_in, fan_out = mats[name]
            out["layers." + name] = ((n, fan_in, fan_out), 0.0,
                                     1.0 / math.sqrt(fan_in))
        elif name.endswith(".b"):
            if c["qkv_bias"]:
                width = dq if name == "attn.q.b" else dkv
                out["layers." + name] = ((n, width), 0.0, BIAS_STD)
        else:
            out["layers." + name] = ((n, d), 1.0, NORM_STD)
    return out


def make_weights(c: dict, seed: int, device) -> dict:
    """Every weight drawn from ``seed`` (one ``normal_`` a stacked
    tensor, on ``device``'s own generator), float32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, (shape, mean, std) in layout(c).items():
        t = torch.empty(shape, dtype=torch.float32, device=device)
        out[name] = t.normal_(mean, std, generator=gen)
    return out


@contextlib.contextmanager
def no_tf32():
    m, d = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = d


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def _rope_tables(n: int, dh: int, theta: float, device):
    i = torch.arange(0, dh, 2, dtype=torch.float64, device=device)
    inv = theta ** (-i / dh)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return (torch.cos(ang).float()[:, None, :],
            torch.sin(ang).float()[:, None, :])


def _rotate(x: torch.Tensor, cos, sin) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def logits(w: dict, c: dict, tokens: torch.Tensor, start: int,
           mm: Callable = torch.matmul) -> torch.Tensor:
    """The logits at positions ``start``.. of one sequence ``tokens``
    (T,), -> (T - start, vocab) float32: the whole forward pass over the
    sequence, one layer at a time."""
    s = sizes(c)
    eps, t = c["rms_norm_eps"], tokens.shape[0]
    heads, kv, dh = s["heads"], s["kv"], s["dh"]
    group = heads // kv
    dev = w["embed.embedding"].device
    tokens = tokens.to(dev).long()
    with torch.no_grad(), no_tf32():
        cos, sin = _rope_tables(t, dh, c["rope_theta"], dev)
        future = torch.ones(t, t, dtype=torch.bool, device=dev).triu(1)
        x = w["embed.embedding"][tokens]
        for i in range(s["layers"]):
            def lw(name):
                return w["layers." + name][i]

            h = _rms(x, lw("norm1.scale"), eps)
            q, k, v = (mm(h, lw(f"attn.{p}.w")) for p in "qkv")
            if c["qkv_bias"]:
                q, k, v = (q + lw("attn.q.b"), k + lw("attn.k.b"),
                           v + lw("attn.v.b"))
            q = _rotate(q.view(t, heads, dh), cos, sin).transpose(0, 1)
            k = _rotate(k.view(t, kv, dh), cos, sin).transpose(0, 1)
            v = v.view(t, kv, dh).transpose(0, 1)
            k = k.repeat_interleave(group, dim=0)          # (H, T, dh)
            v = v.repeat_interleave(group, dim=0)
            scores = mm(q, k.transpose(1, 2)) / math.sqrt(dh)
            scores.masked_fill_(future, float("-inf"))
            a = mm(torch.softmax(scores, dim=-1), v)       # (H, T, dh)
            del scores
            x = x + mm(a.transpose(0, 1).reshape(t, heads * dh),
                       lw("attn.o.w"))
            h = _rms(x, lw("norm2.scale"), eps)
            x = x + mm(torch.nn.functional.silu(mm(h, lw("mlp.gate.w")))
                       * mm(h, lw("mlp.up.w")), lw("mlp.down.w"))
        h = _rms(x[start:], w["final_norm.scale"], eps)
        head = w["embed.embedding" if c["tie_word_embeddings"]
                 else "lm_head.embedding"]
        return mm(h, head[:s["vocab"]].T)
