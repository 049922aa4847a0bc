"""Hierarchical Affinity Propagation's sweeps, in plain PyTorch.

The paper's §3 schedule (all levels Jacobi, two jobs a sweep), from
alpha = rho = 0, tau = +inf, phi = c = 0, with damping lam on rho and
alpha:

    Job 1 (from the second sweep on)
        tau_j^{l+1} = c_j^l + rho_jj^l + sum_{k != j} max(0, rho_kj^l)  (2.4)
        c_i^l = max_j (alpha_ij^l + rho_ij^l)                              (2.6)
        rho_ij = s_ij + min(tau_i, -max_{k != j} (alpha_ik + s_ik))        (2.1)
    Job 2
        phi_i^{l-1} = max_k (alpha_ik^l + s_ik^l), from the old alpha      (2.5)
        alpha_ij = min(0, c_j + phi_j + rho_jj + sum_{k not in {i,j}}
                   max(0, rho_kj))   for i != j                            (2.2)
        alpha_jj = c_j + phi_j + sum_{k != j} max(0, rho_kj)               (2.3)

tau^1 stays +inf and phi^L 0. Each point's exemplar is
argmax_j (alpha_ij + rho_ij), the first column on ties (2.8).

Two layouts: the dense (L, N, N) one, and rows of stored entries (L, N,
k + 1) with an (N, k + 1) map of their columns, slot 0 the diagonal; an
entry not stored is a similarity of -inf. ``rnd`` rounds every state
tensor after each step (the control's precision).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.precision import identity


def _row_max_excluding(v: torch.Tensor) -> torch.Tensor:
    """max over k != j of v[..., k], for every j of the last axis."""
    pos = torch.arange(v.shape[-1], device=v.device)
    first = v.argmax(dim=-1, keepdim=True)
    m1 = v.amax(dim=-1, keepdim=True)
    m2 = torch.where(pos == first, float("-inf"), v).amax(dim=-1,
                                                          keepdim=True)
    return torch.where(pos == first, m2, m1)


def _damp(old, new, lam):
    return lam * old + (1.0 - lam) * new


def dense_sweeps(s3: torch.Tensor, sweeps: int, lam: float,
                 rnd=identity) -> torch.Tensor:
    """Run ``sweeps`` sweeps on the (L, N, N) stack; (L, N) exemplars."""
    levels, n, _ = s3.shape
    eye = torch.eye(n, dtype=torch.bool, device=s3.device)
    r = torch.zeros_like(s3)
    a = torch.zeros_like(s3)
    tau = torch.full((levels, n), float("inf"), device=s3.device)
    phi = torch.zeros((levels, n), device=s3.device)
    c = torch.zeros((levels, n), device=s3.device)

    def col_sums(r):
        rp = torch.where(eye, 0.0, r.clamp_min(0.0))
        return rp, rp.sum(dim=-2)

    for it in range(sweeps):
        if it > 0:
            _, col = col_sums(r[:-1])
            up = c[:-1] + r[:-1].diagonal(dim1=-2, dim2=-1) + col
            tau = rnd(torch.cat([tau[:1], up]))
            c = rnd((a + r).amax(dim=-1))
        rho = s3 + torch.minimum(tau[..., None],
                                 -_row_max_excluding(a + s3))
        r_new = rnd(_damp(r, rho, lam))
        phi = rnd(torch.cat([(a[1:] + s3[1:]).amax(dim=-1), phi[-1:]]))
        rp, col = col_sums(r_new)
        base = (c + phi)[:, None, :]
        rdiag = r_new.diagonal(dim1=-2, dim2=-1)[:, None, :]
        alpha = torch.where(eye, base + col[:, None, :],
                            (base + rdiag + col[:, None, :] - rp)
                            .clamp_max(0.0))
        a = rnd(_damp(a, alpha, lam))
        r = r_new
        del rho, rp, alpha
    return (a + r).argmax(dim=-1)


class Incoming:
    """Each column's stored entries, grouped for its sum: the flat
    positions sorted by column, rows ascending within a column."""

    def __init__(self, idx: torch.Tensor):
        flat = idx.reshape(-1).long()
        self.order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=idx.shape[0])
        self.offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)])

    def sums(self, v: torch.Tensor) -> torch.Tensor:
        """(L, N): each column's entries of ``v`` (L, N, kk) summed, row
        by row in ascending order."""
        flat = v.reshape(v.shape[0], -1)[:, self.order].T.contiguous()
        out = torch.segment_reduce(flat, "sum", offsets=self.offsets,
                                   axis=0, unsafe=True)
        return out.T


def topk_sweeps(s3k: torch.Tensor, idx: torch.Tensor, sweeps: int,
                lam: float, rnd=identity) -> torch.Tensor:
    """Run ``sweeps`` sweeps on the stored entries (L, N, kk) whose
    columns ``idx`` (N, kk) gives; (L, N) exemplars."""
    levels, n, kk = s3k.shape
    dev = s3k.device
    cols = idx.long()
    incoming = Incoming(idx)
    r = torch.zeros_like(s3k)
    a = torch.zeros_like(s3k)
    tau = torch.full((levels, n), float("inf"), device=dev)
    phi = torch.zeros((levels, n), device=dev)
    c = torch.zeros((levels, n), device=dev)
    off = torch.ones(kk, dtype=torch.bool, device=dev)
    off[0] = False                      # slot 0 is the diagonal

    def col_sums(r):
        rp = torch.where(off, r.clamp_min(0.0), 0.0)
        return rp, incoming.sums(rp)

    for it in range(sweeps):
        if it > 0:
            _, col = col_sums(r[:-1])
            up = c[:-1] + r[:-1, :, 0] + col
            tau = rnd(torch.cat([tau[:1], up]))
            c = rnd((a + r).amax(dim=-1))
        rho = s3k + torch.minimum(tau[..., None],
                                  -_row_max_excluding(a + s3k))
        r_new = rnd(_damp(r, rho, lam))
        phi = rnd(torch.cat([(a[1:] + s3k[1:]).amax(dim=-1), phi[-1:]]))
        rp, col = col_sums(r_new)
        base = c + phi
        rdiag = r_new[:, :, 0]
        a_off = (base[:, cols] + rdiag[:, cols] + col[:, cols]
                 - rp).clamp_max(0.0)
        a_self = base + col
        alpha = torch.cat([a_self[..., None], a_off[..., 1:]], dim=-1)
        a = rnd(_damp(a, alpha, lam))
        r = r_new
    v = a + r
    best = v.amax(dim=-1, keepdim=True)
    return torch.where(v == best, cols, n).amin(dim=-1)


def canonical(e: np.ndarray) -> np.ndarray:
    """(L, N) exemplars with one indirection resolved on each level:
    a point follows its exemplar's exemplar."""
    e = np.asarray(e, dtype=np.int64)
    return np.stack([lvl[lvl] for lvl in e])

