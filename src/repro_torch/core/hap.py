"""Hierarchical Affinity Propagation (paper §2, Alg. 1), port of ``repro/core/hap.py``.

State is the paper's six tensors:
    S, alpha, rho : (L, N, N)
    tau, phi, c   : (L, N)
with tau[0] = +inf forever (level 1 has no lower level) and phi[L-1] = 0
forever (the top level has no upper level).

Two sweep orders:

* ``sequential`` — Alg. 1 as printed: levels bottom-up, messages made at
  level l consumed within the same iteration (Gauss-Seidel).
* ``parallel``  — the MapReduce schedule of §3: all levels update from the
  previous iteration's messages (Jacobi). Job 1 updates tau, c, rho; Job 2
  updates phi, alpha; tau and c are skipped on the first iteration.

The per-level functions take any number of leading (level) dimensions, so
the JAX package's ``vmap`` over levels is a written-out batch dimension.
"""
from __future__ import annotations

from typing import Callable, Literal, NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.core.affinity import masked_top2

SweepOrder = Literal["sequential", "parallel"]
SUpdateMode = Literal["off", "paper", "evidence"]


class HAPState(NamedTuple):
    s: torch.Tensor    # (L, N, N) similarities (levels may diverge via eq 2.7)
    r: torch.Tensor    # (L, N, N) responsibilities (rho)
    a: torch.Tensor    # (L, N, N) availabilities (alpha)
    tau: torch.Tensor  # (L, N) upward messages; tau[0] == +inf
    phi: torch.Tensor  # (L, N) downward messages; phi[L-1] == 0
    c: torch.Tensor    # (L, N) cluster preferences


class HAPResult(NamedTuple):
    exemplars: torch.Tensor   # (L, N) int32
    n_clusters: torch.Tensor  # (L,)   int32
    state: HAPState


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


def _clamped_col_sums(r: torch.Tensor) -> torch.Tensor:
    """sum_{k != j} max(0, r_kj) over the second-to-last dimension."""
    eye = _eye(r.shape[-1], r.device)
    return torch.where(eye, 0.0, r.clamp_min(0.0)).sum(dim=-2)


# ---------------------------------------------------------------- per-level
def rho_update(s: torch.Tensor, a: torch.Tensor,
               tau: torch.Tensor) -> torch.Tensor:
    """Eq 2.1: rho_ij = s_ij + min(tau_i, -max_{k!=j}(a_ik + s_ik))."""
    m1, i1, m2 = masked_top2(a + s)
    j = torch.arange(s.shape[-1], device=s.device)
    row_max_excl = torch.where(j == i1.unsqueeze(-1), m2.unsqueeze(-1),
                               m1.unsqueeze(-1))
    return s + torch.minimum(tau.unsqueeze(-1), -row_max_excl)


def alpha_update(r: torch.Tensor, c: torch.Tensor,
                 phi: torch.Tensor) -> torch.Tensor:
    """Eq 2.2/2.3 via clamped column sums (single O(N^2) pass)."""
    eye = _eye(r.shape[-1], r.device)
    rp = torch.where(eye, 0.0, r.clamp_min(0.0))   # max(0, rho_kj), k != j
    col = rp.sum(dim=-2).unsqueeze(-2)             # sum_{k != j}
    rdiag = r.diagonal(dim1=-2, dim2=-1).unsqueeze(-2)
    base = c.unsqueeze(-2) + phi.unsqueeze(-2)
    a_off = (base + rdiag + col - rp).clamp_max(0.0)
    a_diag = base + col
    return torch.where(eye, a_diag, a_off)


def tau_from_level(r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Eq 2.4: tau_j^{l+1} = c_j^l + rho_jj^l + sum_{k!=j} max(0, rho_kj^l)."""
    return c + r.diagonal(dim1=-2, dim2=-1) + _clamped_col_sums(r)


def phi_from_level(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Eq 2.5: phi_i^{l-1} = max_k(alpha_ik^l + s_ik^l)."""
    return (a + s).amax(dim=-1)


def c_update(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Eq 2.6: c_i^l = max_j(alpha_ij^l + rho_ij^l)."""
    return (a + r).amax(dim=-1)


def s_next_level(s_next: torch.Tensor, a: torch.Tensor, r: torch.Tensor,
                 kappa: float, mode: SUpdateMode) -> torch.Tensor:
    """Eq 2.7 (optional): level-wise similarity refinement.

    ``paper`` follows the equation as printed — a per-row shift by
    kappa * max_{j!=i}(a_ij + r_ij). ``evidence`` follows the prose (same
    cluster => reinforce, different => weaken) with the pairwise evidence
    kappa * (a_ij + r_ij); the diagonal (preferences) is preserved.
    """
    eye = _eye(s_next.shape[-1], s_next.device)
    if mode == "paper":
        v = torch.where(eye, float("-inf"), a + r)
        out = s_next + (kappa * v.amax(dim=-1)).unsqueeze(-1)
    elif mode == "evidence":
        out = s_next + kappa * (a + r)
    else:
        return s_next
    return torch.where(eye, s_next, out)


# ------------------------------------------------------------------- sweeps
def hap_init(s3: torch.Tensor) -> HAPState:
    """Paper init: alpha = rho = 0, tau = +inf, phi = 0, c = 0."""
    levels, n, _ = s3.shape
    zv = torch.zeros((levels, n), dtype=s3.dtype, device=s3.device)
    tau = torch.full((levels, n), float("inf"), dtype=s3.dtype,
                     device=s3.device)
    return HAPState(s=s3, r=torch.zeros_like(s3), a=torch.zeros_like(s3),
                    tau=tau, phi=zv, c=zv.clone())


def _damp(old: torch.Tensor, new: torch.Tensor, lam: float) -> torch.Tensor:
    return lam * old + (1.0 - lam) * new


def hap_sweep_sequential(state: HAPState, lam: float, kappa: float,
                         s_mode: SUpdateMode) -> HAPState:
    """One Alg.-1 iteration: bottom-up Gauss-Seidel over levels."""
    levels = state.s.shape[0]
    s, r, a = list(state.s), list(state.r), list(state.a)
    tau, phi, c = list(state.tau), list(state.phi), list(state.c)
    for l in range(levels):
        r[l] = _damp(r[l], rho_update(s[l], a[l], tau[l]), lam)
        a[l] = _damp(a[l], alpha_update(r[l], c[l], phi[l]), lam)
        c[l] = c_update(a[l], r[l])
        if l + 1 < levels:
            tau[l + 1] = tau_from_level(r[l], c[l])
        if l > 0:
            phi[l - 1] = phi_from_level(a[l], s[l])
        if s_mode != "off" and l + 1 < levels:
            s[l + 1] = s_next_level(s[l + 1], a[l], r[l], kappa, s_mode)
    return HAPState(*(torch.stack(x) for x in (s, r, a, tau, phi, c)))


class SweepReducers(NamedTuple):
    """The O(N)-output inter-level reductions a Jacobi sweep needs, each on
    level-stacked tensors. ``jacobi_sweep`` defaults to the dense set."""
    tau: Callable      # (r[:-1], c[:-1]) -> (L-1, N)   Eq 2.4
    phi: Callable      # (a[1:], s[1:])   -> (L-1, N)   Eq 2.5
    c: Callable        # (a, r)           -> (L, N)     Eq 2.6
    s_next: Callable   # (s[1:], a[:-1], r[:-1], kappa, mode) -> (L-1, ...)


DENSE_REDUCERS = SweepReducers(tau=tau_from_level, phi=phi_from_level,
                               c=c_update, s_next=s_next_level)


def jacobi_sweep(state: HAPState, first_iter: bool, *, lam: float,
                 kappa: float, s_mode: SUpdateMode, update_r, update_a,
                 reducers: Optional[SweepReducers] = None) -> HAPState:
    """One MR-schedule iteration (§3) with injected tensor updates.

    The inter-level scaffolding (tau/c kept on the first iteration, phi
    from the previous iteration's alpha, the optional Eq 2.7 refinement)
    is shared; the two heavy per-entry updates vary by backend:

        update_r(s, a, tau, r_old) -> damped rho   (level-stacked)
        update_a(r, c, phi, a_old) -> damped alpha
    """
    red = reducers if reducers is not None else DENSE_REDUCERS
    s, r, a = state.s, state.r, state.a
    tau, phi, c = state.tau, state.phi, state.c

    # --- Job 1: tau^{l+1} and c from the previous iteration; tau[0] = +inf.
    if not first_iter:
        with obs.span("sweep.levels"):
            tau = torch.cat([tau[:1], red.tau(r[:-1], c[:-1])], dim=0)
            c = red.c(a, r)
    with obs.span("sweep.r"):
        r = update_r(s, a, tau, r)

    # --- Job 2: phi^{l-1} from level l's previous alpha; phi[L-1] = 0.
    with obs.span("sweep.levels"):
        phi = torch.cat([red.phi(a[1:], s[1:]), phi[-1:]], dim=0)
    with obs.span("sweep.a"):
        a = update_a(r, c, phi, a)

    if s_mode != "off":
        with obs.span("sweep.levels"):
            s = torch.cat([s[:1], red.s_next(s[1:], a[:-1], r[:-1], kappa,
                                             s_mode)], dim=0)
    return HAPState(s, r, a, tau, phi, c)


def hap_sweep_parallel(state: HAPState, lam: float, kappa: float,
                       s_mode: SUpdateMode, first_iter: bool) -> HAPState:
    """One MR-schedule iteration (§3): all levels Jacobi, two jobs."""
    return jacobi_sweep(
        state, first_iter, lam=lam, kappa=kappa, s_mode=s_mode,
        update_r=lambda s, a, tau, r: _damp(r, rho_update(s, a, tau), lam),
        update_a=lambda r, c, phi, a: _damp(a, alpha_update(r, c, phi), lam))


def assignments(state: HAPState) -> torch.Tensor:
    """Eq 2.8 per level: (L, N) int32 exemplar indices."""
    return torch.argmax(state.a + state.r, dim=2).to(torch.int32)


def extract_exemplars(state: HAPState) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq 2.8 per level + cluster counts (Job 3)."""
    e = assignments(state)
    hot = torch.zeros(e.shape, dtype=torch.bool, device=e.device)
    hot.scatter_(1, e.long(), True)
    return e, hot.sum(dim=1).to(torch.int32)


def run_hap(s3: torch.Tensor, *, iterations: int = 30, damping: float = 0.5,
            order: SweepOrder = "sequential", kappa: float = 0.0,
            s_mode: SUpdateMode = "off") -> HAPResult:
    """Run HAP on an (L, N, N) similarity tensor for ``iterations`` sweeps."""
    state = hap_init(s3.float().contiguous())
    for it in range(iterations):
        if order == "sequential":
            state = hap_sweep_sequential(state, damping, kappa, s_mode)
        else:
            state = hap_sweep_parallel(state, damping, kappa, s_mode, it == 0)
    e, k = extract_exemplars(state)
    return HAPResult(e, k, state)
