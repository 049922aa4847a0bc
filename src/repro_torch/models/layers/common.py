"""Shared building blocks (port of ``repro/models/layers/common.py``).

Parameters live in ``nn.Module``s whose parameter names follow the
reference's key paths (``embed.embedding``, ``units.0_attn.3.attn.q.w``:
a stacked unit's leading axis becomes a ``ModuleList`` index), so that
``repro_torch.convert.lm_params_from_numpy`` is a rename plus an unstack.
Every module records a logical sharding spec ``P`` for each of its
parameters; ``param_specs`` gathers them into the reference's spec tree.

Parameters are float32 (``PARAM_DTYPE``) and cast to bfloat16
(``COMPUTE_DTYPE``) where they are used, as the reference's are;
normalisation statistics and RoPE are computed in float32.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding.partitioning import P
from repro_torch.solver.engine import resolve_device

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


class Init:
    """Where parameters are made and what draws them. ``device`` None means
    the card (a missing card raises); ``generator`` None means a generator
    on that device seeded with 0. On the ``meta`` device nothing is drawn,
    which counts parameters without allocating them."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 device=None):
        self.device = (torch.device("meta") if str(device) == "meta"
                       else resolve_device(device))
        if generator is None and self.device.type != "meta":
            generator = torch.Generator(self.device).manual_seed(0)
        self.generator = generator

    def normal(self, shape, scale: float) -> nn.Parameter:
        if self.device.type == "meta":
            return nn.Parameter(torch.empty(shape, dtype=PARAM_DTYPE,
                                            device=self.device))
        x = torch.randn(shape, generator=self.generator, dtype=PARAM_DTYPE,
                        device=self.device)
        return nn.Parameter(x * scale)

    def full(self, shape, value: float) -> nn.Parameter:
        return nn.Parameter(torch.full(shape, value, dtype=PARAM_DTYPE,
                                       device=self.device))


class Module(nn.Module):
    """An ``nn.Module`` whose parameters each carry a logical spec."""

    def __init__(self):
        super().__init__()
        self.specs: dict[str, P] = {}

    def add(self, name: str, value: nn.Parameter, spec: P) -> None:
        self.register_parameter(name, value)
        self.specs[name] = spec


def param_specs(module: nn.Module) -> dict:
    """The spec tree of ``module``, shaped as the reference's parameter
    tree: a stacked unit (``ModuleList``) gives its first layer's specs
    with a leading None for the unit axis."""
    if isinstance(module, nn.ModuleList):
        return tree_map(lambda s: P(None, *s), param_specs(module[0]),
                        is_leaf=lambda s: isinstance(s, P))
    out = dict(getattr(module, "specs", {}))
    for name, child in module.named_children():
        out[name] = param_specs(child)
    return out


def stacked_tree(module: nn.Module, values: dict, prefix: str = "") -> dict:
    """The reference's tree of ``module``'s parameters, each leaf taken
    from ``values`` by its full parameter name; each ``ModuleList`` is
    stacked (``torch.stack``) on a leading unit axis."""
    if isinstance(module, nn.ModuleList):
        layers = [stacked_tree(m, values, f"{prefix}{i}.")
                  for i, m in enumerate(module)]
        return tree_map(lambda *xs: torch.stack(xs), *layers)
    out = {name: values[prefix + name]
           for name, _ in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        out[name] = stacked_tree(child, values, f"{prefix}{name}.")
    return out


def param_paths(module: nn.Module) -> dict:
    """Parameter name -> (its key path in ``stacked_tree``'s tree, its
    index in that stacked leaf: a tuple, empty where nothing stacks)."""
    out = {}

    def walk(mod, prefix, path, index):
        if isinstance(mod, nn.ModuleList):
            for i, m in enumerate(mod):
                walk(m, f"{prefix}{i}.", path, index + (i,))
            return
        for name, _ in mod.named_parameters(recurse=False):
            out[prefix + name] = (path + (name,), index)
        for name, child in mod.named_children():
            walk(child, f"{prefix}{name}.", path + (name,), index)

    walk(module, "", (), ())
    return out


def tree_get(tree: Any, path: tuple) -> Any:
    for key in path:
        tree = tree[key]
    return tree


# ------------------------------------------------------------------ dense
class Dense(Module):
    """``{"w": (d_in, d_out)}`` (and ``"b"``): x @ w (+ b) in x's dtype."""

    def __init__(self, init: Init, d_in: int, d_out: int, spec: P,
                 bspec: Optional[P] = None, scale: Optional[float] = None):
        super().__init__()
        scale = 1.0 / math.sqrt(d_in) if scale is None else scale
        self.add("w", init.normal((d_in, d_out), scale), spec)
        if bspec is not None:
            self.add("b", init.full((d_out,), 0.0), bspec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_dense(self, x)


def apply_dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if "b" in p.specs:
        y = y + p.b.to(x.dtype)
    return y


class RMSNorm(Module):
    def __init__(self, init: Init, d: int):
        super().__init__()
        self.add("scale", init.full((d,), 1.0), P())

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * self.scale.float()).to(x.dtype)


class LayerNorm(Module):
    def __init__(self, init: Init, d: int):
        super().__init__()
        self.add("scale", init.full((d,), 1.0), P())
        self.add("bias", init.full((d,), 0.0), P())

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * self.scale + self.bias).to(x.dtype)


def norm_class(cfg) -> type:
    return RMSNorm if cfg.norm == "rms" else LayerNorm


# -------------------------------------------------------------- embedding
class Embedding(Module):
    """Vocab rows padded to a multiple of ``pad_to`` (the reference's
    layout, which divides any "model" mesh extent); the pad rows are zero
    and masked in ``unembed``."""

    def __init__(self, init: Init, vocab: int, d: int, pad_to: int = 128):
        super().__init__()
        vpad = ((vocab + pad_to - 1) // pad_to) * pad_to
        w = init.normal((vpad, d), 0.02)
        with torch.no_grad():
            w[vocab:] = 0.0
        self.add("embedding", w, P("model", None))


def apply_embedding(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return p.embedding[tokens.long()].to(COMPUTE_DTYPE)


def unembed(p: Embedding, x: torch.Tensor,
            vocab: Optional[int] = None) -> torch.Tensor:
    """Tied unembedding -> float32 logits; the padded vocab rows are set
    to -1e30 so argmax and logsumexp ignore them."""
    logits = (x @ p.embedding.to(x.dtype).T).float()
    if vocab is not None and vocab < logits.shape[-1]:
        logits[..., vocab:] = -1e30
    return logits


# -------------------------------------------------------------- utilities
def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def tree_map(fn: Callable, *trees, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of equally shaped trees of dicts, lists and
    (named) tuples; None stays None."""
    t = trees[0]
    if is_leaf is not None and is_leaf(t):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees), is_leaf=is_leaf)
                for k in t}
    if isinstance(t, list):
        return [tree_map(fn, *xs, is_leaf=is_leaf) for xs in zip(*trees)]
    if isinstance(t, tuple):
        vals = [tree_map(fn, *xs, is_leaf=is_leaf) for xs in zip(*trees)]
        return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
    if t is None:
        return None
    return fn(*trees)


def count_params(module: Any) -> int:
    return sum(p.numel() for p in module.parameters())
