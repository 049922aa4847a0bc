"""Reusable batched dense-solve handles (port of ``repro/solver/compiled.py``).

The reference lowers and XLA-compiles each handle once
(``jax.jit(...).lower(...).compile()``) so that a service never traces on
its request path. PyTorch runs eagerly: there is no trace to pay and no
executable to keep, so "compiled once" means here that a handle fixes its
(batch, n, d) shape and its config statics at ``compile()``, that ``run``
refuses to start before it, and that callers keep one handle per
``(batch, n, d, config_static_key)`` and reuse it. The two stages run as
plain batched PyTorch on the handle's device:

* ``prepare``: (B, n, d) padded points + (B,) real counts -> the
  similarity stacks, laid out (L, B, n, n). Rows/columns past each
  request's ``n_real`` are the inert dummies of the reference (mutually
  repelling, self-preferring singletons), so a padded solve reproduces the
  unpadded assignment; string preferences ("median"/"range_mid") are
  computed over the *valid* off-diagonal entries only.
* ``solve``: the dense §3 Jacobi schedule over the leading batch
  dimension (the reference's ``vmap``): ``core/hap.py``'s level functions
  take any leading dimensions, so the stack keeps levels first and the
  batch second. Under ``stop="converged"`` each request stops on its own
  sweep, as the vmapped ``while_loop`` does: finished requests keep their
  state while the others sweep on, one host read per sweep.

The handle is dense-family-only, as the reference's is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import hap
from repro_torch.core.similarity import pairwise_similarity
from repro_torch.solver.config import SolveConfig

#: dummy-row similarity floor, matching the reference's ``pad_similarity``
PAD_NEG = -1.0e9

#: orders the batched handle can run (``dense_fused``'s kernels take one
#: level of one request; the handle maps it to the numerically identical
#: parallel order, as the reference does)
_ORDERS = {"dense_sequential": "sequential", "dense_parallel": "parallel",
           "dense_fused": "parallel", "auto": "parallel"}


def batched_order(backend: str) -> str:
    """SolveConfig.backend -> dense sweep order for the batched handle."""
    if backend not in _ORDERS:
        raise ValueError(
            f"the batched serving path runs the dense family only; got "
            f"backend={backend!r} (supported: {sorted(_ORDERS)})")
    return _ORDERS[backend]


def _masked_preference(s: torch.Tensor, valid: torch.Tensor,
                       n_real: torch.Tensor, preference) -> torch.Tensor:
    """(B,) preference over the valid block of each padded (n, n)
    similarity matrix of ``s`` (B, n, n). Strings give
    ``core.preferences``'s value exactly when ``n_real == n`` (the same two
    order statistics)."""
    b, n, _ = s.shape
    if preference is None:
        return torch.zeros(b, dtype=s.dtype, device=s.device)
    if not isinstance(preference, str):
        return torch.full((b,), float(preference), dtype=s.dtype,
                          device=s.device)
    eye = torch.eye(n, dtype=torch.bool, device=s.device)
    off = valid[:, :, None] & valid[:, None, :] & ~eye
    if preference == "median":
        vals = torch.sort(torch.where(off, s, float("inf")).reshape(b, -1),
                          dim=1).values
        cnt = torch.clamp_min(n_real * (n_real - 1), 1)
        lo = vals.gather(1, ((cnt - 1) // 2)[:, None])[:, 0]
        hi = vals.gather(1, (cnt // 2)[:, None])[:, 0]
        return 0.5 * (lo + hi)
    if preference == "range_mid":
        smax = torch.where(off, s, float("-inf")).reshape(b, -1).amax(dim=1)
        smin = torch.where(off, s, float("inf")).reshape(b, -1).amin(dim=1)
        return 0.5 * (smin + smax)
    raise ValueError(
        f"batched solves support 'median'/'range_mid'/explicit preferences; "
        f"got {preference!r} (draw 'random' preferences host-side and pass "
        "the array)")


@dataclasses.dataclass(frozen=True)
class BatchedRawResult:
    """Output of one micro-batch, still bucket-shaped: slice row ``i`` and
    strip to the request's own ``n_real`` to finish it."""
    exemplars: np.ndarray        # (B, L, n) int32
    n_sweeps: np.ndarray         # (B,) int32
    converged: np.ndarray        # (B,) bool
    trace: np.ndarray            # (B, max_iterations) int32, -1 = not run
    preferences: np.ndarray      # (B,) f32 calibrated preference per request


def _batched_init(s4: torch.Tensor) -> hap.HAPState:
    """``hap.hap_init`` for an (L, B, n, n) stack."""
    levels, b, n, _ = s4.shape
    zv = torch.zeros((levels, b, n), dtype=s4.dtype, device=s4.device)
    tau = torch.full((levels, b, n), float("inf"), dtype=s4.dtype,
                     device=s4.device)
    return hap.HAPState(s=s4, r=torch.zeros_like(s4), a=torch.zeros_like(s4),
                        tau=tau, phi=zv, c=zv.clone())


def _run_batched(s4: torch.Tensor, cfg: SolveConfig, order: str):
    """The dense backends' sweep loop over an (L, B, n, n) stack. Returns
    (exemplars (B, L, n), n_sweeps (B,), converged (B,), trace (B, T)) as
    tensors; each request runs as ``dense.run_dense`` would run it alone."""
    levels, b, n, _ = s4.shape
    lam, t_max = cfg.damping, cfg.max_iterations
    device = s4.device
    if order == "sequential":
        def sweep(st, it):
            return hap.hap_sweep_sequential(st, lam, cfg.kappa, cfg.s_mode)
    else:
        def sweep(st, it):
            return hap.hap_sweep_parallel(st, lam, cfg.kappa, cfg.s_mode,
                                          it == 0)

    def assign(st):                          # (L, B, n)
        return torch.argmax(st.a + st.r, dim=-1).to(torch.int32)

    def changes(e_new, e_old):               # (B,)
        return (e_new != e_old).sum(dim=(0, 2)).to(torch.int32)

    state = _batched_init(s4)
    e = torch.full((levels, b, n), -1, dtype=torch.int32, device=device)
    trace = torch.full((b, t_max), -1, dtype=torch.int32, device=device)
    if cfg.stop == "fixed":
        for it in range(t_max):
            state = sweep(state, it)
            e_new = assign(state)
            trace[:, it] = changes(e_new, e)
            e = e_new
        n_sweeps = torch.full((b,), t_max, dtype=torch.int32, device=device)
        return (e.transpose(0, 1), n_sweeps,
                torch.zeros(b, dtype=torch.bool, device=device), trace)

    stable = torch.zeros(b, dtype=torch.int32, device=device)
    its = torch.zeros(b, dtype=torch.int32, device=device)
    active = torch.ones(b, dtype=torch.bool, device=device)
    rows = torch.arange(b, device=device)
    it = 0
    while bool(active.any()):                # host read, once per sweep
        new = sweep(state, it)
        state = hap.HAPState(*(
            torch.where(active.view((1, b) + (1,) * (old.dim() - 2)), nw,
                        old) for nw, old in zip(new, state)))
        e_new = assign(state)
        changed = changes(e_new, e)
        # finished requests write their own entry back: no boolean mask,
        # whose indexing would read the device from the host
        col = its.clamp(max=t_max - 1).long()
        trace[rows, col] = torch.where(active, changed, trace[rows, col])
        stable = torch.where(active, torch.where(changed == 0, stable + 1, 0),
                             stable)
        its = its + active.to(torch.int32)
        e = torch.where(active.view(1, b, 1), e_new, e)
        active = (its < t_max) & (stable < cfg.patience)
        it += 1
    return e.transpose(0, 1), its, stable >= cfg.patience, trace


class BatchedDenseSolver:
    """One handle: fixed (batch, n, d), fixed config statics, on one device.

    ``device`` pins the handle (the serving path's workers each pass their
    own); it wins over ``cfg.device``, and with both None the handle runs
    on "cuda". A CUDA device without a card raises here: nothing falls
    back to the CPU. ``compile()`` is the explicit warm-up point the
    reference has; ``run`` feeds padded host arrays through the two stages.
    """

    def __init__(self, batch: int, n: int, d: int, cfg: SolveConfig,
                 device=None):
        if n < 2:
            raise ValueError(f"bucket n must be >= 2 (got {n})")
        self.batch, self.n, self.d = int(batch), int(n), int(d)
        self.cfg = cfg
        self.order = batched_order(cfg.backend)
        self.device = torch.device(device or cfg.device or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "batched handle on the CPU")
        self._compiled = False

    def _prepare(self, points: torch.Tensor, n_real: torch.Tensor):
        cfg, n = self.cfg, self.n
        s = torch.stack([pairwise_similarity(p, metric=cfg.metric)
                         for p in points])
        valid = torch.arange(n, device=s.device)[None, :] < n_real[:, None]
        s = torch.where(valid[:, :, None] & valid[:, None, :], s,
                        2.0 * PAD_NEG)
        pref = _masked_preference(s, valid, n_real, cfg.preference)
        diag = torch.where(valid, pref[:, None], PAD_NEG)
        s = s.clone()
        s.diagonal(dim1=-2, dim2=-1).copy_(diag)
        return s.unsqueeze(0).expand(cfg.levels, *s.shape).contiguous(), pref

    # --------------------------------------------------------- lifecycle
    @property
    def compiled(self) -> bool:
        return self._compiled

    def compile(self) -> "BatchedDenseSolver":
        """Make the handle ready: the warm-up point of the reference's
        lifecycle. Eager PyTorch has nothing to lower, but a shape's first
        run pays one-time costs of its own (the device's lazily loaded
        kernels, the allocator's first blocks), so ``compile()`` runs the
        handle once, two sweeps of an inert batch (every slot a two-point
        filler), and a service that warms its handles does not make its
        first request pay them."""
        self._compiled = True
        pts = torch.zeros((self.batch, self.n, self.d), device=self.device)
        n_real = torch.full((self.batch,), 2, dtype=torch.int64,
                            device=self.device)
        s4, _ = self._prepare(pts, n_real)
        _run_batched(s4, self.cfg.replace(
            max_iterations=min(2, self.cfg.max_iterations)), self.order)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # ------------------------------------------------------------- run
    def run(self, points: np.ndarray, n_real: np.ndarray
            ) -> BatchedRawResult:
        """points (B, n, d) f32 (padded), n_real (B,) int32 -> results.

        Raises if ``compile()`` has not run, as the reference does.
        """
        if not self.compiled:
            raise RuntimeError(
                "BatchedDenseSolver.run before compile(); warm the "
                "service (ClusterService.warmup) first")
        pts = torch.as_tensor(np.asarray(points, np.float32),
                              device=self.device)
        nr = torch.as_tensor(np.asarray(n_real, np.int64),
                             device=self.device)
        s4, pref = self._prepare(pts, nr)
        e, n_sweeps, conv, trace = _run_batched(s4, self.cfg, self.order)
        return BatchedRawResult(
            exemplars=e.cpu().numpy(), n_sweeps=n_sweeps.cpu().numpy(),
            converged=conv.cpu().numpy(), trace=trace.cpu().numpy(),
            preferences=pref.cpu().numpy())


def config_static_key(cfg: SolveConfig) -> tuple:
    """The SolveConfig fields a handle specializes on (the reference's,
    and the device). Two configs with equal keys can share one handle."""
    pref = cfg.preference
    if isinstance(pref, (np.ndarray, torch.Tensor, list, tuple)):
        raise ValueError(
            "per-point preference arrays are request data, not config; "
            "pass a scalar or strategy string to the service")
    return (batched_order(cfg.backend), cfg.levels, cfg.metric, pref,
            cfg.max_iterations, float(cfg.damping), float(cfg.kappa),
            cfg.s_mode, cfg.stop, cfg.patience, cfg.device)


def slice_request(raw: BatchedRawResult, i: int, n_real: int,
                  stop: str) -> "tuple":
    """Row ``i`` of a micro-batch -> the engine's RawBackendResult plus
    the calibrated preference (streams keep it for drift detection)."""
    from repro_torch.solver.result import RawBackendResult

    n_sweeps = int(raw.n_sweeps[i])
    trace: Optional[np.ndarray] = raw.trace[i][:n_sweeps]
    converged = bool(raw.converged[i]) if stop == "converged" else None
    rbr = RawBackendResult(
        exemplars=raw.exemplars[i][:, :n_real], n_sweeps=n_sweeps,
        converged=converged, trace=trace)
    return rbr, float(raw.preferences[i])
