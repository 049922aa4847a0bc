"""Single-device dense sweep drivers (port of ``repro/solver/dense.py``).

* ``fused_sweep`` — one Jacobi (§3-schedule) HAP iteration whose heavy
  O(L*N^2) updates run through the responsibility and availability
  kernels, level by level, writing straight into the level-stacked output.
  The O(N)-output inter-level reductions (tau, phi, c) stay plain PyTorch
  reductions, as they stay XLA reductions in the reference.
* ``drive_sweeps`` — the stopping-rule loop: ``stop="fixed"`` runs exactly
  ``max_iterations`` sweeps and keeps the per-sweep change counts on the
  device, read once at the end; ``stop="converged"`` reads the change
  count on the host once per sweep (one device sync per sweep) to decide
  whether to stop.
* ``run_dense`` — what the dense backends call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hap
from repro_torch.kernels import ops

DenseOrder = ("sequential", "parallel", "fused")


def fused_sweep(state: hap.HAPState, first_iter: bool, *, lam: float,
                kappa: float, s_mode: str) -> hap.HAPState:
    """One MR-schedule iteration with kernel tensor updates; shares
    ``hap.jacobi_sweep``'s Job-1/Job-2 scaffolding with
    ``hap_sweep_parallel``."""
    def update_r(s, a, tau, r):
        out = torch.empty_like(r)
        for l in range(s.shape[0]):
            ops.responsibility(s[l], a[l], tau[l], r[l], lam=lam, out=out[l])
        return out

    def update_a(r, c, phi, a):
        out = torch.empty_like(a)
        for l in range(r.shape[0]):
            ops.availability(r[l], c[l], phi[l], a[l], lam=lam, out=out[l])
        return out

    return hap.jacobi_sweep(state, first_iter, lam=lam, kappa=kappa,
                            s_mode=s_mode, update_r=update_r,
                            update_a=update_a)


def _make_sweep(order: str, damping: float, kappa: float, s_mode: str):
    if order == "sequential":
        return lambda st, it: hap.hap_sweep_sequential(
            st, damping, kappa, s_mode)
    if order == "parallel":
        return lambda st, it: hap.hap_sweep_parallel(
            st, damping, kappa, s_mode, it == 0)
    if order == "fused":
        return lambda st, it: fused_sweep(
            st, it == 0, lam=damping, kappa=kappa, s_mode=s_mode)
    raise ValueError(f"unknown dense order {order!r}")


def drive_sweeps(init, sweep, assign, levels: int, n: int, *,
                 max_iterations: int, stop: str, patience: int):
    """The stopping-rule loop every single-device backend shares.

    ``sweep(state, it) -> state`` and ``assign(state) -> (L, N) int32``
    are backend-specific. Returns ``(state, exemplars, n_sweeps, converged,
    trace)``; ``trace`` is a numpy array of length ``max_iterations`` with
    -1 past ``n_sweeps``.
    """
    device = init.s.device
    e = torch.full((levels, n), -1, dtype=torch.int32, device=device)
    state = init
    if stop == "fixed":
        trace = torch.empty(max_iterations, dtype=torch.int32, device=device)
        for it in range(max_iterations):
            state = sweep(state, it)
            e_new = assign(state)
            trace[it] = (e_new != e).sum()
            e = e_new
        return state, e, max_iterations, False, trace.cpu().numpy()

    trace = np.full(max_iterations, -1, np.int32)
    stable = it = 0
    while it < max_iterations and stable < patience:
        state = sweep(state, it)
        e_new = assign(state)
        changed = int((e_new != e).sum())    # host sync, once per sweep
        stable = stable + 1 if changed == 0 else 0
        trace[it] = changed
        e = e_new
        it += 1
    return state, e, it, stable >= patience, trace


def run_dense(s3: torch.Tensor, *, order: str, max_iterations: int,
              damping: float = 0.5, kappa: float = 0.0, s_mode: str = "off",
              stop: str = "fixed", patience: int = 5):
    """Run a dense backend on an (L, N, N) stack.

    Returns ``(state, exemplars, n_sweeps, converged, trace)`` — see
    ``drive_sweeps`` for the trace convention.
    """
    s3 = s3.float().contiguous()
    levels, n, _ = s3.shape
    sweep = _make_sweep(order, damping, kappa, s_mode)
    return drive_sweeps(hap.hap_init(s3), sweep, hap.assignments, levels, n,
                        max_iterations=max_iterations, stop=stop,
                        patience=patience)
