"""Dense sweep drivers and the shared stopping-rule loop (port of
``repro/solver/dense.py``).

* ``fused_sweep`` — one Jacobi (§3-schedule) HAP iteration whose heavy
  O(L*N^2) updates run through the responsibility and availability
  kernels, level by level, writing straight into the level-stacked output.
  The O(N)-output inter-level reductions (tau, phi, c) stay plain PyTorch
  reductions, as they stay XLA reductions in the reference.
* ``drive_sweeps`` — the stopping-rule loop: ``stop="fixed"`` runs exactly
  ``max_iterations`` sweeps and keeps the per-sweep change counts on the
  device, read once at the end; ``stop="converged"`` reads the change
  count on the host once per sweep (one device sync per sweep) to decide
  whether to stop. Its segmented mode runs the same loop between
  checkpoints.
* ``run_dense`` — what the dense backends call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import hap
from repro_torch.kernels import ops
from repro_torch.sharding.dist import psum

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


def initial_carry(init, levels: int, n: int, max_iterations: int):
    """The loop carry ``(state, e_prev, stable, it, trace)`` before the
    first sweep: no exemplar yet (-1), no sweep done, the trace all -1."""
    e0 = torch.full((levels, n), -1, dtype=torch.int32, device=init.s.device)
    return init, e0, 0, 0, np.full(max_iterations, -1, np.int32)


def drive_sweeps(init, sweep, assign, levels: int, n: int, *,
                 max_iterations: int, stop: str, patience: int,
                 count_mask=None, axis=None,
                 segmented: bool = False, carry=None, until=None):
    """The stopping-rule loop every sweep-based backend shares.

    ``sweep(state, it) -> state`` and ``assign(state) -> (L, N) int32``
    are backend-specific. Returns ``(state, exemplars, n_sweeps, converged,
    trace)``; ``trace`` is a numpy array of length ``max_iterations`` with
    -1 past ``n_sweeps``.

    ``stop="fixed"`` keeps the per-sweep change counts on the device and
    reads them once, at the end; ``stop="converged"`` reads the count once
    per sweep to decide whether to stop.

    Row-sharded callers (``solver.topk_sharded``) run this loop on every
    rank with ``n`` their local row count: ``count_mask`` ((n,) bool) drops
    padding rows from the change count, and ``axis`` (a
    ``sharding.dist.Axis``) sums the counts over the ranks, so every rank
    sees the one-device run's trace and stops on its sweep. Under
    ``"fixed"`` the whole count vector is summed once, at the end.

    Checkpointed callers (``solver.checkpointing``) set ``segmented=True``
    to run one *segment*: ``carry`` is the raw carry ``(state, e_prev,
    stable, it, trace)`` of the previous segment (None: start fresh;
    ``stable`` and ``it`` are ints, ``trace`` a numpy array), ``until`` the
    sweep index to pause at, and the raw carry comes back. A plain run is
    one segment to ``max_iterations``: the plain, the checkpointed and a
    resumed run execute the same sweeps on the same state, so resume is
    bit-exact by construction, as in the reference.
    """
    with obs.span("sweeps"):
        if carry is None:
            carry = initial_carry(init, levels, n, max_iterations)
        state, e, stable, it, trace = carry
        trace = trace.copy()
        until = max_iterations if until is None else until

        def count(e_new, e_old):
            diff = e_new != e_old
            if count_mask is not None:
                diff = diff & count_mask
            return diff.sum()

        def reduce(counts):
            return counts if axis is None else psum(counts, axis)

        if stop == "fixed":
            # the patience exit is off; the stable count is kept for the
            # carry (the reference's segments keep it too)
            start = it
            changes = torch.empty(until - start, dtype=torch.int64,
                                  device=e.device)
            for it in range(start, until):
                state = sweep(state, it)
                with obs.span("sweep.assign"):
                    e_new = assign(state)
                    changes[it - start] = count(e_new, e)
                e = e_new
            it = until
            # the one host read
            counts = obs.to_host(reduce(changes), "sweeps").numpy()
            trace[start:it] = counts
            for changed in counts:
                stable = stable + 1 if changed == 0 else 0
        else:
            while it < until and stable < patience:
                state = sweep(state, it)
                with obs.span("sweep.assign"):
                    e_new = assign(state)
                    # the host read, once a sweep
                    changed = int(obs.to_host(reduce(count(e_new, e)),
                                              "sweeps"))
                stable = stable + 1 if changed == 0 else 0
                trace[it] = changed
                e = e_new
                it += 1
        if segmented:
            return state, e, stable, it, trace
        return state, e, it, stop == "converged" and stable >= patience, trace


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
