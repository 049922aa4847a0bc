"""Damped responsibility update (Eq 2.1): CUDA kernel and plain version.

Replaces ``src/repro/kernels/responsibility.py:responsibility_pallas``.
The kernel is ``csrc/responsibility.cu``: one block per row reads ``a``
and ``s``, reduces (max, first argmax, second max) and emits the damped
row, reading the row of ``s`` again (expected to hit L2) — bound by the bytes
of four N x N matrices, with no intermediate ``a + s`` in device memory.
It is bit-identical to ``plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.kernels import (
    _build, check_operands, on_cpu, ref, stream_of,
)

#: The plain PyTorch version.
plain = ref.responsibility


def responsibility(s: torch.Tensor, a: torch.Tensor, tau: torch.Tensor,
                   r_old: torch.Tensor, lam: float, *,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """s, a, r_old (N, M); tau (N,) -> damped rho (N, M), written into
    ``out`` when given."""
    if on_cpu("responsibility", s, a, tau, r_old,
              *(() if out is None else (out,))):
        res = plain(s, a, tau, r_old, lam)
        return res if out is None else out.copy_(res)
    n, m = s.shape
    if out is None:
        out = torch.empty((n, m), dtype=torch.float32, device=s.device)
    check_operands("responsibility", s=(s, (n, m)), a=(a, (n, m)),
                   tau=(tau, (n,)), r_old=(r_old, (n, m)), out=(out, (n, m)))
    # lam and 1 - lam rounded to f32 as PyTorch rounds the plain version's
    # Python-float scalars.
    with torch.cuda.device(s.device):
        err = _build.lib().repro_responsibility(
            s.data_ptr(), a.data_ptr(), tau.data_ptr(), r_old.data_ptr(),
            out.data_ptr(), n, m, ctypes.c_float(lam),
            ctypes.c_float(1.0 - lam), stream_of(s))
    _build.check(err, "responsibility")
    obs.count("launches.responsibility")
    return out
