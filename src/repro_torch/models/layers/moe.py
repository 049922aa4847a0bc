"""Token-dropping top-k Mixture-of-Experts (port of
``repro/models/layers/moe.py``).

Two paths, as in the reference:

* **dense** (no mesh in context): every expert on one device.
* **sharded** (a mesh with a "model" axis in context, ``set_mesh``): the
  rank runs on its data block of the tokens. Expert-parallel when the
  experts divide the model axis (rank m holds experts
  [m * E / model, (m + 1) * E / model)); otherwise ffn-parallel, each rank
  holding a slice of every expert's hidden dim; and where that does not
  divide either, the dense path. One sum over "model" combines the
  ranks' outputs in both layouts.

Each token picks ``top_k`` experts from the full router; the choices are
ranked within their expert by a stable sort (token order) and those past
the static capacity C = max(4, ceil(T * k / E * cf)) are dropped, T the
tokens the rank routes. The routing decisions must equal the
reference's: ``jax.lax.top_k`` puts the lower index first among equal
probabilities, and ``torch.topk`` promises no order, so the top k are
taken from a stable descending sort. The router product is float32 (TF32
must be off on the card). Every shape in the dispatch is fixed by the
input's (a trash row takes the dropped choices), so the layer runs on the
``meta`` device, where the dry run counts it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import Init, Module, P
from repro_torch.sharding import dist
from repro_torch.sharding.partitioning import get_abstract_mesh


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
    counts = torch.zeros(e_loc + 1, dtype=local_e.dtype,
                         device=xt.device).index_add_(
        0, local_e, torch.ones_like(local_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * top_k_, device=xt.device) - starts[sorted_e]
    keep = (sorted_e < e_loc) & (rank < cap)
    dest = torch.where(keep, sorted_e * cap + rank, e_loc * cap)
    # every choice is written; the dropped ones all land on the trash row,
    # which is cut off (so no gradient reaches them)
    buf = torch.zeros((e_loc * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((dest,), xt[order // top_k_])
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


def _aux(probs, flat_e, t: int, top_k_: int, e_total: int,
         data_axes: tuple = ()):
    """Switch-style load-balancing loss. On a mesh the expert shares and
    mean probabilities are averaged over the data axes before their
    product, as the reference's ``pmean``s do."""
    share = torch.full(flat_e.shape, 1.0 / (t * top_k_), device=probs.device)
    frac = torch.zeros(e_total, device=probs.device).index_add_(
        0, flat_e, share)
    mean_prob = probs.mean(0)
    for ax in data_axes:
        frac = _MeanOverRanks.apply(frac, ax)
        mean_prob = _MeanOverRanks.apply(mean_prob, ax)
    return e_total * (frac * mean_prob).sum()


def moe_apply(p: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25) -> MoEOut:
    """x: (B, S, D) -> (B, S, D). With a mesh that has a "model" axis in
    context, ``x`` is this rank's data block and the sharded path runs;
    otherwise the dense one."""
    mesh = get_abstract_mesh()
    if not mesh.empty and "model" in mesh.axis_names:
        return _moe_sharded(p, x, top_k=top_k,
                            capacity_factor=capacity_factor, mesh=mesh)
    return _moe_dense(p, x, top_k=top_k, capacity_factor=capacity_factor)


def _moe_dense(p: MoE, x: torch.Tensor, *, top_k: int,
               capacity_factor: float, data_axes: tuple = ()) -> MoEOut:
    b, s, d = x.shape
    e = p.router.shape[-1]
    t = b * s
    cap = capacity(t, top_k, e, capacity_factor)
    buf, (inv, top_w, probs, flat_e) = _route_and_dispatch(
        x.reshape(t, d), p.router, top_k, 0, e, cap)
    out_buf = _ffn(p.gate, p.up, p.down, buf)
    y = _combine(out_buf, inv, top_w, t, top_k).reshape(b, s, d)
    aux = _aux(probs, flat_e, t, top_k, e, data_axes)
    return MoEOut(y.to(x.dtype), aux.float(), probs)


# -------------------------------------------------------------- mesh path
def sharded_layout(n_experts: int, d_ff: int, model: int):
    """How the experts lie over a model axis of ``model`` ranks:
    "expert" (expert-parallel), "ffn" (the hidden dim split) or None (the
    dense path: neither divides)."""
    if n_experts % model == 0:
        return "expert"
    if d_ff % model == 0:
        return "ffn"
    return None


def holds_expert_block(p: MoE) -> bool:
    """Whether ``p``'s expert weights hold only this rank's experts (their
    leading dim E / model < E), so a rank need not hold the whole layer."""
    return p.gate.shape[0] < p.router.shape[-1]


def expert_block(p: MoE, model_axis) -> tuple:
    """(gate, up, down) as this rank of ``model_axis`` uses them: its
    experts (expert-parallel) or its slice of the hidden dim (ffn). Expert
    weights that hold only the rank's experts are given as they are."""
    if holds_expert_block(p):
        return p.gate, p.up, p.down
    layout = sharded_layout(p.router.shape[-1], p.gate.shape[-1],
                            model_axis.size)
    m, i = model_axis.size, model_axis.index
    if layout == "expert":
        n = p.gate.shape[0] // m
        return tuple(w.narrow(0, i * n, n) for w in (p.gate, p.up, p.down))
    n = p.gate.shape[-1] // m
    return (p.gate.narrow(2, i * n, n), p.up.narrow(2, i * n, n),
            p.down.narrow(1, i * n, n))


def _moe_sharded(p: MoE, x: torch.Tensor, *, top_k: int,
                 capacity_factor: float, mesh) -> MoEOut:
    e = p.router.shape[-1]
    model = mesh.axis("model")
    data_axes = tuple(mesh.axis(a) for a in ("pod", "data")
                      if a in mesh.axis_names)
    if holds_expert_block(p):
        if p.gate.shape[0] * model.size != e:
            raise ValueError(f"{p.gate.shape[0]} experts a rank on a model "
                             f"axis of {model.size} for {e} experts")
        layout = "expert"
    else:
        layout = sharded_layout(e, p.gate.shape[-1], model.size)
    if layout is None:
        # the reference runs its dense path on the whole batch here; the
        # port on this rank's block, its capacity from the block's tokens
        return _moe_dense(p, x, top_k=top_k, capacity_factor=capacity_factor,
                          data_axes=data_axes)
    gate, up, down = expert_block(p, model)
    b, s, d = x.shape
    t = b * s
    if layout == "expert":
        e_loc = gate.shape[0]
        e_lo = model.index * e_loc
    else:
        e_loc, e_lo = e, 0
    # capacity from the rank's own tokens, as the reference's shard_map
    # body computes it: so the sharded path drops other choices than the
    # dense one unless the capacity holds every choice
    cap = capacity(t, top_k, e, capacity_factor)
    xt = _ToModelRanks.apply(x.reshape(t, d), model)
    router = _ToModelRanks.apply(p.router, model)
    buf, (inv, top_w, probs, flat_e) = _route_and_dispatch(
        xt, router, top_k, e_lo, e_loc, cap)
    out_buf = _ffn(gate, up, down, buf)
    y_part = _combine(out_buf, inv, top_w, t, top_k)
    # expert-parallel: sums each token's k rank-local expert outputs;
    # ffn-parallel: sums the hidden-dim partial products. One sum.
    y = _SumOverRanks.apply(y_part, model)
    aux = _aux(probs, flat_e, t, top_k, e, data_axes)
    # aux and the probabilities are computed alike on every model rank;
    # the gradient sums at the inputs would count them once a rank
    aux = _Replicated.apply(aux, model)
    probs = _Replicated.apply(probs, model)
    return MoEOut(y.reshape(b, s, d).to(x.dtype), aux.float(), probs)


class _ToModelRanks(torch.autograd.Function):
    """Identity forward; the gradients of the model ranks summed backward
    (each rank's use of a model-replicated input is partial)."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return dist.psum(g.contiguous(), ctx.ax), None


class _SumOverRanks(torch.autograd.Function):
    """The sum over the model ranks forward (``dist.psum``, rank order);
    the identity backward: the output is replicated over the model axis,
    and so is its cotangent, which is what the reference's ``shard_map``
    transpose hands each rank."""

    @staticmethod
    def forward(ctx, x, ax):
        return dist.psum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """Identity forward; the cotangent divided by the model ranks
    backward, for a value every model rank computes alike from inputs
    whose gradients ``_ToModelRanks`` sums."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.n = ax.size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _MeanOverRanks(torch.autograd.Function):
    """The mean over a data axis forward (the sum in rank order, then the
    division); the identity backward: the train step averages the data
    ranks' gradients, and the average of the ranks' equal cotangents is
    the mean's transpose."""

    @staticmethod
    def forward(ctx, x, ax):
        return dist.psum(x, ax) / ax.size

    @staticmethod
    def backward(ctx, g):
        return g, None
