"""Train-step factory (port of ``repro/train/loop.py``): next-token CE plus
the MoE aux loss, AdamW, optional microbatch gradient accumulation and
top-k gradient compression.

``TrainState(params, opt, step)``: ``params`` is the model, the
``nn.Module`` that ``repro_torch.models.model_init`` returns; ``opt.mu``
and ``opt.nu`` are dicts keyed by its parameter names
(``model.named_parameters()``, e.g. ``units.0_attn.3.attn.q.w``);
``opt.count`` and ``step`` are int32 scalars on the model's device.
``repro_torch.convert.train_state_to_numpy`` gives the same state as the
reference's ``TrainState`` tree (stacked units, the reference's key paths,
which is what a checkpoint stores) and ``train_state_from_numpy`` takes it
back, so a training checkpoint of either package restores in the other.

On a mesh (``make_train_step(..., mesh=)``) the state is that tree of
each rank's blocks, and the step gathers, reduces and updates them
explicitly (``_mesh_train_step``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import Mode, model_apply
from repro_torch.models.layers.common import (
    P, param_paths, stacked_tree, tree_get, tree_map,
)
from repro_torch.runtime.compression import compress_tree_grads
from repro_torch.sharding import dist
from repro_torch.sharding.partitioning import (
    Sharding, _axes, _entry, set_mesh, shape_safe_shardings,
)
from repro_torch.train.optimizer import (
    AdamWState, adamw_init, adamw_update_, tree_leaves,
)
from repro_torch.train.schedule import cosine_warmup


class TrainState(NamedTuple):
    params: Any             # the model (nn.Module), or a spec tree
    opt: AdamWState
    step: Any               # int32 scalar tensor, or a spec


def init_train_state(params: nn.Module) -> TrainState:
    """A fresh state around ``params`` (held, not copied): zero moments and
    step 0 on the model's device."""
    opt = adamw_init(dict(params.named_parameters()))
    return TrainState(params, opt, torch.zeros_like(opt.count))


def _zero_extend(spec: P) -> P:
    """ZeRO-style: additionally shard optimizer moments over "data".

    The first dim already sharded gains a trailing "data" factor; fully
    replicated leaves get "data" on dim 0. A sharded layout drops the
    factor wherever the dim cannot divide, so this is always safe."""
    entries = list(spec)
    used = {a for e in entries if e is not None
            for a in ((e,) if isinstance(e, str) else tuple(e))}
    if "data" in used:
        return spec                      # already data-sharded somewhere
    for i, e in enumerate(entries):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        entries[i] = (*axes, "data")
        return P(*entries)
    if entries:
        entries[0] = "data"
        return P(*entries)
    return P("data")


def train_state_specs(param_specs: Any, zero: bool = True) -> TrainState:
    """The state's spec tree from ``model_init``'s parameter specs;
    zero=True shards the Adam moments additionally over "data" (ZeRO-1).
    The mesh step lays the state out by it."""
    moment_specs = param_specs
    if zero:
        moment_specs = tree_map(_zero_extend, param_specs,
                                is_leaf=lambda s: isinstance(s, P))
    return TrainState(
        params=param_specs,
        opt=AdamWState(mu=moment_specs, nu=moment_specs, count=P()),
        step=P(),
    )


def _loss_fn(params: nn.Module, cfg: ArchConfig, inputs: dict, mode: Mode,
             aux_weight: float = 0.01):
    """Next-token CE over the token region (modality prefixes excluded),
    logits in float32, plus ``aux_weight`` times the MoE aux loss."""
    logits, _, aux = model_apply(params, cfg, inputs, mode)
    tokens = inputs["tokens"]
    n_tok = tokens.shape[1]
    logits = logits[:, -n_tok:]                   # drop img/frame prefix
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1].float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    return ce + aux_weight * aux, (ce, aux)


def make_train_step(
    cfg: ArchConfig, mode: Mode, *, microbatches: int = 1,
    compress: str | None = None, compress_ratio: float = 0.01,
    compress_min_size: int = 65536, lr_kwargs: dict | None = None,
    mesh=None, state_specs: TrainState | None = None,
):
    """Returns ``train_step(state, inputs) -> (state, metrics)``, metrics
    ``loss, ce, aux, lr, grad_finite`` as scalar tensors on the device.

    The step updates the state it is given in place: the model's
    parameters and the moment tensors are overwritten (under no_grad), and
    the returned ``TrainState`` holds the same model and moment dicts with
    a new ``count`` and ``step``. Copy a state (``copy.deepcopy``) to keep
    it.

    microbatches > 1 splits the batch, sums the float32 gradients of the
    splits (sequential: the standard memory/throughput trade) and scales
    them, the loss and its parts by 1 / microbatches.
    compress="topk" applies top-k sparsification to the gradients
    (``runtime.compression.compress_tree_grads``) before the update.

    With ``mesh`` (a ``launch.mesh.WorkerMesh`` with "data" and "model"
    axes, "pod" too on a multi-pod mesh; every rank of it calls the step
    with the same global batch) the state is the reference's tree of this
    rank's blocks (``runtime.elastic.reshard_state`` under
    ``state_specs``, by default ``train_state_specs`` of the model's
    specs) and the step is the mesh step below; it returns a state of new
    parameter blocks and the same moment blocks, updated in place. The
    mesh step takes no compression.
    """
    if compress not in (None, "topk"):
        raise ValueError(f"compress={compress!r}: None or 'topk'")
    lr_kwargs = lr_kwargs or {}
    if mesh is not None:
        if compress is not None:
            raise ValueError("the mesh train step takes no compression")
        return _mesh_train_step(cfg, mode, mesh, state_specs, microbatches,
                                lr_kwargs)

    def train_step(state: TrainState, inputs: dict):
        model = state.params
        (loss, ce, aux), grads = _grads(model, cfg, mode, inputs,
                                        microbatches)
        if compress == "topk":
            grads = compress_tree_grads(grads, ratio=compress_ratio,
                                        min_size=compress_min_size)
        lr = cosine_warmup(state.step, **lr_kwargs)
        opt = adamw_update_(grads, state.opt, dict(model.named_parameters()),
                            lr)
        metrics = {"loss": loss, "ce": ce, "aux": aux, "lr": lr,
                   "grad_finite": _finite(grads)}
        return TrainState(model, opt, state.step + 1), metrics

    return train_step


def _finite(grads: Any) -> torch.Tensor:
    return torch.stack([torch.isfinite(g).all()
                        for g in tree_leaves(grads)]).all()


def _grads(model: nn.Module, cfg: ArchConfig, mode: Mode, inputs: dict,
           microbatches: int):
    """-> ((loss, ce, aux), {parameter name: gradient}) of ``inputs``,
    the splits' float32 gradients summed and scaled by 1 / microbatches."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.grad = None
    if microbatches == 1:
        splits = [inputs]
    else:
        b = inputs["tokens"].shape[0]
        splits = [{k: v.reshape(microbatches, b // microbatches,
                                *v.shape[1:])[i]
                   for k, v in inputs.items()}
                  for i in range(microbatches)]
    sums = None
    with torch.enable_grad():
        for mb in splits:
            loss, (ce, aux) = _loss_fn(model, cfg, mb, mode)
            loss.backward()      # sums into .grad across the splits
            vals = torch.stack([loss.detach(), ce.detach(),
                                aux.detach().float()])
            sums = vals if sums is None else sums + vals
    grads = {n: p.grad for n, p in named.items()}
    for p in named.values():
        p.grad = None
    if microbatches > 1:
        inv = 1.0 / microbatches
        sums = sums * inv
        grads = {n: g * inv for n, g in grads.items()}
    return sums, grads


# ------------------------------------------------------------ mesh step
def data_axes(mesh) -> tuple:
    """The mesh's axes that split the batch, major first."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_block(inputs: dict, mesh) -> dict:
    """This rank's rows of every input: the batch split over the data
    axes (pod major), as ``input_sharding`` lays it out."""
    sh = Sharding(mesh, P(_entry(data_axes(mesh))))
    return {k: sh.block(v) for k, v in inputs.items()}


def shard_train_state(state: TrainState, spec_tree: TrainState,
                      mesh) -> TrainState:
    """This rank's blocks of a whole state in the reference's tree (what
    ``convert.train_state_to_numpy`` gives, or meta tensors for the dry
    run) under the shape-safe layout the mesh step uses, on the leaves'
    device. ``runtime.elastic.reshard_state`` gives the same where the
    specs divide every leaf, and raises where they do not."""
    shardings = shape_safe_shardings(mesh, state, spec_tree)
    return tree_map(lambda sh, x: sh.block(x), shardings, state,
                    is_leaf=_is_sharding)


def _is_sharding(x) -> bool:
    return isinstance(x, Sharding)


class _LeafPlan(NamedTuple):
    """How the mesh step reduces one leaf's gradient to its moment block."""
    model_psum: bool      # sum over "model" first (a MoE's expert weights
    #                       whose moment block is not the rank's own slice)
    spec_nd: P            # the moment spec without the data axes
    scatter_dim: Any      # the dim "data" splits (None: a psum)
    norm_axes: tuple      # the axes whose ranks hold distinct blocks


def _leaf_plan(spec_m: P, compute_dim, mesh) -> _LeafPlan:
    d_names = data_axes(mesh)
    scatter_dim = None
    for i, entry in enumerate(spec_m):
        axes = _axes(entry)
        if "pod" in axes or ("data" in axes and axes[-1] != "data"):
            # ZeRO appends "data" last; parameters never carry "pod"
            raise ValueError(f"the mesh step needs \"data\" last in its "
                             f"dim and no \"pod\" in a moment spec: {spec_m}")
        if "data" in axes:
            scatter_dim = i
    spec_nd = P(*(_entry(tuple(a for a in _axes(e) if a not in d_names))
                  for e in spec_m))
    held = {a for e in spec_m for a in _axes(e)}
    model_psum = compute_dim is not None and (
        compute_dim >= len(spec_nd) or "model" not in _axes(spec_nd[compute_dim]))
    return _LeafPlan(model_psum, spec_nd, scatter_dim,
                     tuple(a for a in mesh.axis_names if a in held))


def _mesh_train_step(cfg, mode, mesh, state_specs, microbatches,
                     lr_kwargs):
    """The train step on a (pod, data, model) mesh: the arithmetic that
    the reference gets from GSPMD through its specs, made explicit. The
    state is the reference's tree (stacked units) of this rank's blocks:
    parameters under their specs, the moments under the ZeRO-1 specs
    (``runtime.elastic.reshard_state`` of a restored state). A step

    1. gathers the whole parameters into a working model on the rank;
    2. runs forward and backward on the rank's data block of the batch
       with the mesh in context, so a MoE layer takes its sharded path;
    3. reduces each gradient to the rank's moment block: the block of its
       non-data axes, then the sum over the data axes in rank order
       (``dist.psum_scatter`` over "data", where the moment spec splits a
       dim over it; ``dist.psum`` otherwise), divided by their ranks: the
       gradient of the global batch's mean loss, the data blocks being
       equal. A MoE's expert weights, whose gradient a model rank holds
       only for its own experts (or hidden-dim slice), are first summed
       over "model" where the moment block is not that slice;
    4. clips by the global norm of the whole leaves: the squares of the
       blocks summed over the axes whose ranks hold distinct blocks, equal
       on every rank;
    5. updates the moments and parameters of its moment blocks only, then
       gathers the parameter blocks back from them (ZeRO-1).
    """
    from repro_torch.models import model_init
    from repro_torch.models.layers.moe import MoE, sharded_layout

    d_axes = [mesh.axis(a) for a in data_axes(mesh)]
    n_data = math.prod(ax.size for ax in d_axes)
    built: dict = {}

    def setup(state: TrainState) -> dict:
        if built:
            return built
        # drawn values (none on ``meta``), overwritten by every step's gather
        model, specs = model_init(None, cfg,
                                  device=tree_leaves(state.params)[0].device)
        spec_tree = state_specs or train_state_specs(specs)
        # the whole leaves' shapes (stacking meta tensors would take
        # torch's Python decompositions, slow to import)
        with torch.no_grad():
            shapes = stacked_tree(model, dict(model.named_parameters()))
        paths = param_paths(model)
        # the dim a model rank's compute slice of each expert weight cuts
        compute_dim = {}
        if "model" in mesh.axis_names:
            for name, mod in model.named_modules():
                layout = isinstance(mod, MoE) and sharded_layout(
                    mod.router.shape[-1], mod.gate.shape[-1],
                    mesh.shape["model"])
                for w, ffn_dim in (("gate", 2), ("up", 2), ("down", 1)):
                    if layout:
                        path, index = paths[f"{name}.{w}"]
                        compute_dim[path] = len(index) + (
                            0 if layout == "expert" else ffn_dim)
        moment_sh = shape_safe_shardings(mesh, shapes, spec_tree.opt.mu)
        plans = {}
        for name in dict(model.named_parameters()):
            path = paths[name][0]
            plans[path] = _leaf_plan(tree_get(moment_sh, path).spec,
                                     compute_dim.get(path), mesh)
        built.update(
            model=model, paths=paths, plans=plans, moment_sh=moment_sh,
            param_sh=shape_safe_shardings(mesh, shapes, spec_tree.params))
        return built

    def reduce(path: tuple, g: torch.Tensor) -> torch.Tensor:
        plan = built["plans"][path]
        if plan.model_psum:
            g = dist.psum(g, mesh.axis("model"))
        g = Sharding(mesh, plan.spec_nd).block(g)
        for ax in d_axes:
            if ax.name == "data" and plan.scatter_dim is not None:
                g = dist.psum_scatter(g, ax, axis=plan.scatter_dim)
            else:
                g = dist.psum(g, ax)
        return g / n_data

    def global_sum(per_leaf: dict) -> torch.Tensor:
        """The sum over the whole leaves of a per-block quantity: each
        group of leaves summed over the axes of their distinct blocks."""
        groups: dict = {}
        for path, v in per_leaf.items():
            groups.setdefault(built["plans"][path].norm_axes, []).append(v)
        total = None
        for axes in sorted(groups):
            v = torch.stack(groups[axes]).sum()
            for a in axes:
                v = dist.psum(v, mesh.axis(a))
            total = v if total is None else total + v
        return total

    def train_step(state: TrainState, inputs: dict):
        b = setup(state)
        model = b["model"]
        full = tree_map(lambda sh, x: sh.gather(x), b["param_sh"],
                        state.params, is_leaf=_is_sharding)
        with torch.no_grad():
            for name, p in model.named_parameters():
                path, index = b["paths"][name]
                p.copy_(tree_get(full, path)[index])
        with set_mesh(mesh):
            sums, grads = _grads(model, cfg, mode, data_block(inputs, mesh),
                                 microbatches)
        for ax in d_axes:
            sums = dist.psum(sums, ax)
        loss, ce, aux = sums / n_data
        grads = _map_with_path(reduce, stacked_tree(model, grads))
        flat = {}
        _map_with_path(lambda path, g: flat.setdefault(path, g), grads)
        norm = torch.sqrt(global_sum({p: torch.sum(torch.square(g.float()))
                                      for p, g in flat.items()}))
        bad = global_sum({p: (~torch.isfinite(g)).sum().float()
                          for p, g in flat.items()})
        lr = cosine_warmup(state.step, **lr_kwargs)
        p_own = tree_map(lambda sh, x: sh.block(x), b["moment_sh"], full,
                         is_leaf=_is_sharding)
        opt = adamw_update_(grads, state.opt, p_own, lr, norm=norm)
        params = tree_map(lambda msh, psh, x: msh.gather(x, psh.spec),
                          b["moment_sh"], b["param_sh"], p_own,
                          is_leaf=_is_sharding)
        metrics = {"loss": loss, "ce": ce, "aux": aux, "lr": lr,
                   "grad_finite": bad == 0}
        return TrainState(params, opt, state.step + 1), metrics

    train_step.setup = setup     # builds the working model ahead of a step
    return train_step


def _map_with_path(fn, tree: dict, path: tuple = ()) -> dict:
    """``fn(key path, leaf)`` over a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)
