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
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import Mode, model_apply
from repro_torch.models.layers.common import P, tree_map
from repro_torch.runtime.compression import compress_tree_grads
from repro_torch.train.optimizer import AdamWState, adamw_init, adamw_update_
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
    Nothing on one device reads it; it is kept for the sharded path."""
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
    """
    if compress not in (None, "topk"):
        raise ValueError(f"compress={compress!r}: None or 'topk'")
    lr_kwargs = lr_kwargs or {}

    def grads_of(model: nn.Module, inputs: dict):
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

    def train_step(state: TrainState, inputs: dict):
        model = state.params
        (loss, ce, aux), grads = grads_of(model, inputs)
        if compress == "topk":
            grads = compress_tree_grads(grads, ratio=compress_ratio,
                                        min_size=compress_min_size)
        finite = torch.stack([torch.isfinite(g).all()
                              for g in grads.values()]).all()
        lr = cosine_warmup(state.step, **lr_kwargs)
        opt = adamw_update_(grads, state.opt, dict(model.named_parameters()),
                            lr)
        metrics = {"loss": loss, "ce": ce, "aux": aux, "lr": lr,
                   "grad_finite": finite}
        return TrainState(model, opt, state.step + 1), metrics

    return train_step
