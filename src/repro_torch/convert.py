"""Carry HAP state between the JAX reference and the port.

There are no model weights in this system; the state of a solve is the
six ``HAPState`` tensors (s, r, a, tau, phi, c). The reference's state
crosses as numpy arrays (``np.asarray`` of each field), so this module
imports neither package's framework beyond torch.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.hap import HAPState


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
