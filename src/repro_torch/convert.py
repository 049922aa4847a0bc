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
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.hap import HAPState
from repro_torch.solver import checkpointing
from repro_torch.solver.topk import TopKState


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
