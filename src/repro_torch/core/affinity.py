"""Flat Affinity Propagation (Frey & Dueck 2007), port of ``repro/core/affinity.py``.

Updates (damped by lambda):
    r(i,j) <- s(i,j) - max_{k != j} (a(i,k) + s(i,k))
    a(i,j) <- min(0, r(j,j) + sum_{k not in {i,j}} max(0, r(k,j)))   (i != j)
    a(j,j) <- sum_{k != j} max(0, r(k,j))
    e(i)   =  argmax_j (a(i,j) + r(i,j))

The row max over ``k != j`` uses the top-2 trick: one pass finds the row
maximum and runner-up; entry j reads the runner-up iff j is the argmax.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class APState(NamedTuple):
    r: torch.Tensor  # responsibilities (N, N)
    a: torch.Tensor  # availabilities   (N, N)


class APResult(NamedTuple):
    exemplars: torch.Tensor   # (N,) int32 — e_i = argmax_j(a+r)
    r: torch.Tensor
    a: torch.Tensor
    n_clusters: torch.Tensor  # scalar int32


def masked_top2(row: torch.Tensor, dim: int = -1):
    """(max, argmax, second-max) along ``dim``; the argmax is the first
    occurrence of the maximum (``torch.argmax`` guarantees it)."""
    m1 = row.amax(dim=dim)
    i1 = row.argmax(dim=dim)
    masked = row.scatter(dim, i1.unsqueeze(dim), float("-inf"))
    m2 = masked.amax(dim=dim)
    return m1, i1, m2


def _row_max_excluding_self(v: torch.Tensor) -> torch.Tensor:
    m1, i1, m2 = masked_top2(v)
    j = torch.arange(v.shape[-1], device=v.device)
    return torch.where(j == i1.unsqueeze(-1), m2.unsqueeze(-1),
                       m1.unsqueeze(-1))


def responsibility_update(s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """r(i,j) = s(i,j) - max_{k != j}(a(i,k) + s(i,k)) via top-2."""
    return s - _row_max_excluding_self(a + s)


def availability_update(r: torch.Tensor) -> torch.Tensor:
    """a(i,j) from clamped column sums; diagonal handled separately."""
    n = r.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=r.device)
    rp = torch.where(eye, 0.0, r.clamp_min(0.0))
    col = rp.sum(dim=-2)                    # sum_{k != j} max(0, r(k,j))
    rdiag = r.diagonal(dim1=-2, dim2=-1)
    a_off = (rdiag.unsqueeze(-2) + col.unsqueeze(-2) - rp).clamp_max(0.0)
    return torch.where(eye, col.unsqueeze(-2).expand_as(r), a_off)


def affinity_propagation(s: torch.Tensor, *, iterations: int = 100,
                         damping: float = 0.5) -> APResult:
    """Run flat AP for a fixed number of damped iterations."""
    n = s.shape[-1]
    s = s.float()
    state = APState(torch.zeros_like(s), torch.zeros_like(s))
    for _ in range(iterations):
        r = damping * state.r + (1.0 - damping) * responsibility_update(
            s, state.a)
        a = damping * state.a + (1.0 - damping) * availability_update(r)
        state = APState(r, a)
    e = torch.argmax(state.a + state.r, dim=1).to(torch.int32)
    # a point is an exemplar iff some point (possibly itself) selects it
    is_exemplar = torch.zeros(n, dtype=torch.bool, device=s.device)
    is_exemplar[e.long()] = True
    return APResult(e, state.r, state.a, is_exemplar.sum().to(torch.int32))


def net_similarity(s: torch.Tensor, exemplars: torch.Tensor) -> torch.Tensor:
    """Frey's energy: sum_i s(i, e_i) with preferences for self-exemplars."""
    return torch.gather(s, 1, exemplars.long().unsqueeze(1)).sum()
