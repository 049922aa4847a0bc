"""AdamW with global-norm clipping (port of ``repro/train/optimizer.py``).
The optimizer state mirrors the parameter tree (dicts, lists and named
tuples of tensors), so the moments shard as the parameters do.

The update is the reference's formula in its order of operations: the
gradients scaled by min(1, clip / max(global norm, 1e-12)); the moments;
bias corrections from ``count``; p - lr ((m / bc1) / (sqrt(v / bc2) + eps)
+ wd p). ``torch.optim.AdamW`` with ``clip_grad_norm_`` clips otherwise
(it divides by norm + 1e-6), so it is not used.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.layers.common import tree_map


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor     # int32 scalar: the updates taken


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts, lists and (named) tuples, in the
    order ``tree_map`` visits them."""
    out = []
    tree_map(out.append, tree)
    return out


def adamw_init(params: Any) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(mu=tree_map(torch.zeros_like, params),
                      nu=tree_map(torch.zeros_like, params),
                      count=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update_(
    grads: Any, state: AdamWState, params: Any, lr, *,
    b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
    weight_decay: float = 0.1, clip_norm: float = 1.0, norm=None,
) -> AdamWState:
    """The update written into ``params`` and the state's moments in
    place, leaf by leaf (the temporaries are one leaf's); -> the state with
    the same moment trees and the new count. ``norm`` is the gradients'
    global norm where ``grads`` hold only blocks of them (a mesh step);
    None computes it from ``grads``."""
    gn = global_norm(grads) if norm is None else norm
    scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    count = state.count + 1
    c = count.to(torch.float32)
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c

    def one(p, g, m, v):
        g = g * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p.copy_((p - lr * (step + weight_decay * p)).to(p.dtype))

    tree_map(one, params, grads, state.mu, state.nu)
    return AdamWState(state.mu, state.nu, count)


def adamw_update(grads: Any, state: AdamWState, params: Any, lr,
                 **hyper) -> tuple[Any, AdamWState]:
    """-> (new parameters, new state); nothing given is modified
    (``adamw_update_`` on copies)."""
    params, mu, nu = (tree_map(torch.clone, t)
                      for t in (params, state.mu, state.nu))
    return params, adamw_update_(grads, AdamWState(mu, nu, state.count),
                                 params, lr, **hyper)
