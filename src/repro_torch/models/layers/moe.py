"""Token-dropping top-k Mixture-of-Experts, the dense (one-device) path
(port of ``repro/models/layers/moe.py::_moe_dense``).

Each token picks ``top_k`` experts from the full router; the choices are
ranked within their expert by a stable sort (token order) and those past
the static capacity C = max(4, ceil(T * k / E * cf)) are dropped. The
routing decisions must equal the reference's: ``jax.lax.top_k`` puts the
lower index first among equal probabilities, and ``torch.topk`` promises
no order, so the top k are taken from a stable descending sort. The
router product is float32 (TF32 must be off on the card). The sharded
dispatch (``_moe_sharded``) is not ported yet (ROADMAP A.9.4).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import Init, Module, P


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor
    router_probs: torch.Tensor  # (T, E): the HAP expert-affinity hook's input


class MoE(Module):
    """``{"router": (D, E), "gate", "up": (E, D, F), "down": (E, F, D)}``."""

    def __init__(self, init: Init, d_model: int, d_ff: int, n_experts: int):
        super().__init__()
        s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
        # the reference's specs: experts over "model" where they can divide
        # a 16-way axis, else the FFN hidden dim
        if n_experts >= 16:
            s_gate, s_down = P("model", None, "data"), P("model", "data", None)
        else:
            s_gate, s_down = P(None, "data", "model"), P(None, "model", "data")
        self.add("router", init.normal((d_model, n_experts), s_in),
                 P(None, None))
        self.add("gate", init.normal((n_experts, d_model, d_ff), s_in), s_gate)
        self.add("up", init.normal((n_experts, d_model, d_ff), s_in), s_gate)
        self.add("down", init.normal((n_experts, d_ff, d_model), s_out),
                 s_down)

    def forward(self, x: torch.Tensor, *, top_k: int,
                capacity_factor: float = 1.25) -> MoEOut:
        return moe_apply(self, x, top_k=top_k,
                         capacity_factor=capacity_factor)


def ordered_top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: (values, indices), ties to the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(t: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    return max(4, int(math.ceil(t * top_k / n_experts * capacity_factor)))


def _route_and_dispatch(xt, router, top_k_: int, e_lo: int, e_loc: int,
                        cap: int):
    """-> (buf (e_loc, cap, D), (inv, top_w, probs, flat_e)). ``inv`` maps
    each (token, choice) to its row of the flattened buffer, or to the
    trash row ``e_loc * cap`` when the choice was dropped or is outside
    the experts [e_lo, e_lo + e_loc)."""
    t, d = xt.shape
    probs = torch.softmax(xt.float() @ router, dim=-1)       # (T, E)
    top_w, top_i = ordered_top_k(probs, top_k_)
    top_w = top_w / top_w.sum(-1, keepdim=True)

    flat_e = top_i.reshape(-1)
    mine = (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
    local_e = torch.where(mine, flat_e - e_lo, e_loc)       # e_loc = trash
    order = torch.argsort(local_e, stable=True)
    sorted_e = local_e[order]
    counts = torch.bincount(local_e, minlength=e_loc + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * top_k_, device=xt.device) - starts[sorted_e]
    keep = (sorted_e < e_loc) & (rank < cap)
    dest = torch.where(keep, sorted_e * cap + rank, e_loc * cap)
    buf = torch.zeros((e_loc * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf[dest[keep]] = xt[(order // top_k_)[keep]]
    inv = torch.empty_like(dest)
    inv[order] = dest
    return buf[:-1].reshape(e_loc, cap, d), (inv, top_w, probs, flat_e)


def _combine(out_buf, inv, top_w, t: int, top_k_: int):
    e_loc, cap, d = out_buf.shape
    out_flat = torch.cat([out_buf.reshape(e_loc * cap, d),
                          out_buf.new_zeros((1, d))])
    per_choice = out_flat[inv].reshape(t, top_k_, d)
    return (per_choice * top_w.to(per_choice.dtype)[..., None]).sum(1)


def _ffn(w_gate, w_up, w_down, h):
    """Every expert's SwiGLU on its buffer: h (E, C, D) -> (E, C, D)."""
    act = F.silu(h @ w_gate.to(h.dtype)) * (h @ w_up.to(h.dtype))
    return act @ w_down.to(h.dtype)


def _aux(probs, flat_e, t: int, top_k_: int, e_total: int):
    """Switch-style load-balancing loss."""
    share = torch.full(flat_e.shape, 1.0 / (t * top_k_), device=probs.device)
    frac = torch.zeros(e_total, device=probs.device).index_add_(
        0, flat_e, share)
    return e_total * (frac * probs.mean(0)).sum()


def moe_apply(p: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25) -> MoEOut:
    """x: (B, S, D) -> (B, S, D), on one device (the reference's
    ``_moe_dense``)."""
    b, s, d = x.shape
    e = p.router.shape[-1]
    t = b * s
    cap = capacity(t, top_k, e, capacity_factor)
    buf, (inv, top_w, probs, flat_e) = _route_and_dispatch(
        x.reshape(t, d), p.router, top_k, 0, e, cap)
    out_buf = _ffn(p.gate, p.up, p.down, buf)
    y = _combine(out_buf, inv, top_w, t, top_k).reshape(b, s, d)
    aux = _aux(probs, flat_e, t, top_k, e)
    return MoEOut(y.to(x.dtype), aux.float(), probs)
