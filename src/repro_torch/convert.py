"""Carry HAP state between the JAX reference and the port.

There are no model weights in this system; the state of a solve is the
six ``HAPState`` tensors (s, r, a, tau, phi, c), and for ``dense_topk``
also the (N, kk) index map of the compressed layout (``TopKState``). The
reference's state crosses as numpy arrays (``np.asarray`` of each field),
so this module imports neither package's framework beyond torch.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.hap import HAPState
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
