"""Carry HAP state between the JAX reference and the port.

There are no model weights in this system; the state of a solve is the
six ``HAPState`` tensors (s, r, a, tau, phi, c), and for ``dense_topk``
also the (N, kk) index map of the compressed layout (``TopKState``). The
reference's state crosses as numpy arrays (``np.asarray`` of each field),
so this module imports neither package's framework beyond torch.

State also crosses on disk. ``repro_torch.checkpoint`` writes and reads
the reference's checkpoint format (``arrays.npz`` + ``manifest.json`` with
jax's key-path strings, ``step_{:010d}`` directories, the
``solve_meta.json`` sidecar), so a checkpointed ``dense_topk`` or
``coarsen`` run of either package resumes in the other
(``SolveConfig.resume_from``). ``carry_from_checkpoint`` reads the newest
sweep checkpoint of such a directory as the port's loop carry.

The LM scaffolding's parameters cross the same way: the reference's
parameter tree (``np.asarray`` of each leaf, nested dicts) loads into the
port's model, whose parameter names follow the tree's key paths; a stacked
unit's leading axis is unstacked into its ``ModuleList``. Decode states
(``KVCache`` and the recurrent states, in either layout) cross likewise,
and so does the training state (``TrainState``: parameters, the Adam
moments, the counts), on disk too: its tree carries the reference's key
paths.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from torch import nn

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.hap import HAPState
from repro_torch.models import model_init
from repro_torch.models.encdec import EncDecState
from repro_torch.models.layers.attention import KVCache
from repro_torch.models.layers.common import stacked_tree, tree_map
from repro_torch.models.layers.rglru import RGLRUState
from repro_torch.models.layers.xlstm import MLSTMState, SLSTMState
from repro_torch.solver import checkpointing
from repro_torch.solver.engine import resolve_device
from repro_torch.solver.topk import TopKState
from repro_torch.train.loop import TrainState
from repro_torch.train.optimizer import AdamWState


def hap_state_from_numpy(arrays: Sequence[np.ndarray],
                         device="cpu") -> HAPState:
    """Six arrays in ``HAPState`` field order -> the port's ``HAPState``
    (float32 tensors on ``device``)."""
    if len(arrays) != len(HAPState._fields):
        raise ValueError(f"expected {len(HAPState._fields)} arrays "
                         f"{HAPState._fields}, got {len(arrays)}")
    return HAPState(*(torch.tensor(np.asarray(a, np.float32), device=device)
                      for a in arrays))


def hap_state_to_numpy(state: HAPState) -> HAPState:
    """The port's ``HAPState`` -> the same fields as numpy arrays."""
    return HAPState(*(t.detach().cpu().numpy() for t in state))


def topk_state_from_numpy(hap_arrays: Sequence[np.ndarray], idx: np.ndarray,
                          device="cpu") -> TopKState:
    """The reference's compressed state (six (L, N, kk) / (L, N) arrays in
    ``HAPState`` field order, and the (N, kk) index map) -> the port's
    ``TopKState`` on ``device`` (float32 fields, int32 ``idx``)."""
    return TopKState(hap_state_from_numpy(hap_arrays, device),
                     torch.tensor(np.asarray(idx, np.int32), device=device))


def topk_state_to_numpy(state: TopKState) -> TopKState:
    """The port's ``TopKState`` -> the same fields as numpy arrays."""
    return TopKState(hap_state_to_numpy(state.hap),
                     state.idx.detach().cpu().numpy())


def carry_from_checkpoint(directory: str, device="cpu"):
    """The newest ``step_*`` checkpoint of a checkpointed ``dense_topk``
    run (written by either package) -> the port's loop carry ``(HAPState,
    e_prev, stable, it, trace)``: the state and ``e_prev`` as tensors on
    ``device``, ``stable`` and ``it`` as ints, ``trace`` a numpy array."""
    hit = CheckpointManager(directory, async_save=False).restore_latest(
        checkpointing._carry_like())
    if hit is None:
        raise ValueError(f"{directory!r} holds no step_* checkpoints")
    return checkpointing.carry_from_tree(hit[1], device)


# ------------------------------------------------------------ LM models
def lm_params_from_numpy(tree: dict, cfg, device=None) -> nn.Module:
    """The reference's parameter tree for ``cfg`` (nested dicts of numpy
    arrays, stacked units with their leading unit axis) -> the port's model
    (``repro_torch.models.model_init``'s module) on ``device`` (None: the
    card; raises without one) holding those values, dtypes kept. Raises on
    a missing or extra key, or a shape or dtype that differs."""
    device = resolve_device(device)
    model, _ = model_init(None, cfg, device="meta")
    model = model.to_empty(device=device)
    with torch.no_grad():
        _load(model, tree, "")
    return model


def lm_params_to_numpy(model: nn.Module) -> dict:
    """The port's model -> the reference's parameter tree (nested dicts of
    numpy arrays, each ``ModuleList`` stacked on a leading unit axis)."""
    return _module_tree(model, dict(model.named_parameters()), "")


def _module_tree(module: nn.Module, values: dict, prefix: str) -> dict:
    """The reference's tree of ``module``'s parameters, each leaf taken
    from ``values`` by its full parameter name, as numpy."""
    return tree_map(lambda t: t.detach().cpu().numpy(),
                    stacked_tree(module, values, prefix))


# ---------------------------------------------------------- LM training
def train_state_from_numpy(tree, cfg, device=None) -> TrainState:
    """The reference's training state for ``cfg`` (its ``TrainState`` or
    any tree with ``params``, ``opt.mu``, ``opt.nu``, ``opt.count`` and
    ``step``, numpy leaves; what ``CheckpointManager.restore_latest``
    returns) -> the port's ``TrainState`` on ``device`` (None: the card;
    raises without one): the model, the moments keyed by its parameter
    names, int32 ``count`` and ``step``."""
    device = resolve_device(device)
    model = lm_params_from_numpy(tree.params, cfg, device)
    mu, nu = ({n: p.detach() for n, p in
               lm_params_from_numpy(t, cfg, device).named_parameters()}
              for t in (tree.opt.mu, tree.opt.nu))

    def scalar(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                            device=device)
    return TrainState(model, AdamWState(mu, nu, scalar(tree.opt.count)),
                      scalar(tree.step))


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The port's ``TrainState`` -> the reference's ``TrainState`` tree
    with numpy leaves (the parameter tree and both moments with stacked
    units, int32 scalars ``opt.count`` and ``step``). Its key paths are
    the reference's, so ``CheckpointManager.save`` of it writes what the
    reference writes for its state."""
    model = state.params
    return TrainState(
        params=lm_params_to_numpy(model),
        opt=AdamWState(mu=_module_tree(model, state.opt.mu, ""),
                       nu=_module_tree(model, state.opt.nu, ""),
                       count=np.asarray(int(state.opt.count), np.int32)),
        step=np.asarray(int(state.step), np.int32))


def _load(module: nn.Module, tree, path: str) -> None:
    if isinstance(module, nn.ModuleList):
        for i, layer in enumerate(module):
            _load(layer, tree_map(lambda a: a[i], tree), f"{path}{i}.")
        return
    params = dict(module.named_parameters(recurse=False))
    children = dict(module.named_children())
    if set(tree) != set(params) | set(children):
        raise ValueError(f"{path or 'the root'}: the tree has keys "
                         f"{sorted(tree)}, the model "
                         f"{sorted(set(params) | set(children))}")
    for name, p in params.items():
        src = _tensor(tree[name])
        if src.shape != p.shape or src.dtype != p.dtype:
            raise ValueError(f"{path}{name}: {tuple(src.shape)} {src.dtype}"
                             f" where the model has {tuple(p.shape)} "
                             f"{p.dtype}")
        p.copy_(src)
    for name, child in children.items():
        _load(child, tree[name], f"{path}{name}.")


_STATE_TYPES = {t.__name__: t for t in (KVCache, RGLRUState, MLSTMState,
                                         SLSTMState, EncDecState)}


def lm_state_from_numpy(tree, device=None):
    """A reference decode state (``model_state_init``'s or a prefill's
    output, ``np.asarray`` of each leaf: dicts, lists and its named tuples)
    -> the port's state on ``device`` (None: the card; raises without one),
    each named tuple as the port's type of the same name, dtypes kept
    (bfloat16 included)."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        if isinstance(node, tuple):
            return _STATE_TYPES[type(node).__name__](*(conv(v) for v in node))
        return _tensor(node).to(device)

    return conv(tree)


def lm_state_to_numpy(state):
    """The port's decode state -> the same tree with numpy leaves (bfloat16
    leaves widened to float32, exactly: numpy has no bfloat16)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(leaf, state)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())
