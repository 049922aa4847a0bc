"""The registered backends (port of ``repro/solver/backends.py``).

Importing this module populates the registry. Ported so far:

dense_sequential   Alg. 1 as printed (Gauss-Seidel over levels), 1 device
dense_parallel     §3 Jacobi schedule, plain PyTorch sweeps, 1 device
dense_fused        §3 Jacobi schedule, CUDA responsibility/availability
                   kernels in the per-level hot loop

The reference's other backends (dense_topk, graph_affinity, mr1d_stats,
mr1d_transpose, mr2d, sharded_streaming, coarsen) come with later slices.
"""
from __future__ import annotations

from repro_torch.solver import dense
from repro_torch.solver.config import SolveConfig
from repro_torch.solver.registry import BackendSpec, register_backend
from repro_torch.solver.result import RawBackendResult


def _dense_runner(order: str):
    def run(s3, cfg: SolveConfig) -> RawBackendResult:
        state, e, n_sweeps, conv, trace = dense.run_dense(
            s3, order=order, max_iterations=cfg.max_iterations,
            damping=cfg.damping, kappa=cfg.kappa, s_mode=cfg.s_mode,
            stop=cfg.stop, patience=cfg.patience)
        return RawBackendResult(
            exemplars=e, n_sweeps=n_sweeps,
            converged=bool(conv) if cfg.stop == "converged" else None,
            trace=trace[:n_sweeps],
            state=state if cfg.keep_state else None)
    return run


register_backend(BackendSpec(
    name="dense_sequential", run=_dense_runner("sequential"),
    supports_early_stop=True,
    doc="Alg. 1 Gauss-Seidel dense sweeps (single device)"))

register_backend(BackendSpec(
    name="dense_parallel", run=_dense_runner("parallel"),
    supports_early_stop=True,
    doc="MR Jacobi schedule, plain PyTorch dense sweeps (single device)"))

register_backend(BackendSpec(
    name="dense_fused", run=_dense_runner("fused"),
    supports_early_stop=True,
    doc="MR Jacobi schedule with the CUDA kernels in the hot loop"))
