"""Public kernel entry points (port of ``repro/kernels/ops.py``).

Each op launches its CUDA kernel for CUDA tensors and runs the kernel's
plain PyTorch version for CPU tensors. The TPU tiling knob ``block`` and
the ``use_ref`` switch of the JAX package have no counterpart: the CUDA
kernels pick their own launch shapes, and the plain versions are reached
through the kernel modules' ``plain`` (never as a fallback).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import availability as _availability
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import responsibility as _responsibility
from repro_torch.kernels import similarity as _similarity


def neg_sqeuclidean(x: torch.Tensor,
                    y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, d), y (M, d) (default x) -> (N, M) negative squared distances."""
    return _similarity.neg_sqeuclidean(x, x if y is None else y)


def responsibility(s, a, tau, r_old, *, lam: float = 0.5, out=None):
    """Damped Eq 2.1 for one level: (N, M) inputs, tau (N,)."""
    return _responsibility.responsibility(s, a, tau, r_old, lam, out=out)


def availability(r, c, phi, a_old, *, lam: float = 0.5, out=None):
    """Damped Eq 2.2/2.3 for one level: (N, N) inputs, c and phi (N,)."""
    return _availability.availability(r, c, phi, a_old, lam, out=out)


def hap_iteration_kernels(s, r, a, tau, c, phi, *, lam: float = 0.5):
    """One flat-AP-level (rho then alpha) iteration built from the kernels."""
    r = responsibility(s, a, tau, r, lam=lam)
    a = availability(r, c, phi, a, lam=lam)
    return r, a


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Forward flash attention over (BH, S, D) tensors (heads folded into
    batch), f32 or bf16. GQA callers broadcast the KV heads to the
    query-head count before folding."""
    return _flash_attention.flash_attention(q, k, v, causal)


def affinity_propagation_kernels(s: torch.Tensor, *, iterations: int = 100,
                                 lam: float = 0.5):
    """Flat AP driven entirely by the kernels; returns (exemplars, r, a)."""
    n = s.shape[-1]
    s = s.float().contiguous()
    tau = torch.full((n,), float("inf"), device=s.device)
    zero = torch.zeros(n, device=s.device)
    r, a = torch.zeros_like(s), torch.zeros_like(s)
    for _ in range(iterations):
        r, a = hap_iteration_kernels(s, r, a, tau, zero, zero, lam=lam)
    return torch.argmax(a + r, dim=1).to(torch.int32), r, a
