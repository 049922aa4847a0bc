"""The registered backends (port of ``repro/solver/backends.py``).

Importing this module populates the registry. Ported so far:

dense_sequential   Alg. 1 as printed (Gauss-Seidel over levels), 1 device
dense_parallel     §3 Jacobi schedule, plain PyTorch sweeps, 1 device
dense_fused        §3 Jacobi schedule, CUDA responsibility/availability
                   kernels in the per-level hot loop
dense_topk         §3 Jacobi schedule on top-k-per-row sparse
                   similarities; O(L*N*k) state, exact at k = N-1; from
                   points the CUDA fused top-k build on the card
sharded_streaming  two-tier shard-local AP, O((N/S)^2) peak state
coarsen            kd-partition -> batched local dense solves -> global
                   exemplar solve; the N=1e7-on-one-host route

The reference's other backends (graph_affinity, mr1d_stats,
mr1d_transpose, mr2d) come with later slices.
"""
from __future__ import annotations

from repro_torch.core.streaming import streaming_hap
from repro_torch.solver import dense, topk
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


def _topk_run(data, cfg: SolveConfig) -> RawBackendResult:
    """Compressed-layout Jacobi sweeps; O(L*N*k) state instead of
    O(L*N^2). Takes raw points (the top-k build; the N x N matrix is never
    built) or an (L, N, N) similarity stack (row-wise compression); the
    engine refuses edge-list input until the graph slice."""
    if cfg.checkpoint_every > 0 or cfg.resume_from:
        raise NotImplementedError(
            "checkpoint/resume of dense_topk comes with the fault-tolerance "
            "slice (ROADMAP.md queue A.5)")
    n = data.shape[1] if data.ndim == 3 else data.shape[0]
    k = topk.resolve_k(cfg.k, n)
    if data.ndim == 3:
        s3k, idx = topk.compress_stack(data, k)
    else:
        s3k, idx = topk.build_from_points(
            data, k, cfg.levels, metric=cfg.metric,
            preference=cfg.preference, seed=cfg.seed, config=cfg)
    state, e, n_sweeps, conv, trace = topk.run_topk(
        s3k, idx, max_iterations=cfg.max_iterations, damping=cfg.damping,
        kappa=cfg.kappa, s_mode=cfg.s_mode, stop=cfg.stop,
        patience=cfg.patience)
    return RawBackendResult(
        exemplars=e, n_sweeps=n_sweeps,
        converged=bool(conv) if cfg.stop == "converged" else None,
        trace=trace[:n_sweeps], state=state if cfg.keep_state else None)


register_backend(BackendSpec(
    name="dense_topk", run=_topk_run, accepts_points=True,
    supports_early_stop=True,
    doc="top-k-per-row sparse similarities; O(L*N*k) state, exact at "
        "k=N-1"))


def _streaming_run(x, cfg: SolveConfig) -> RawBackendResult:
    res = streaming_hap(
        x, shard_size=cfg.shard_size, iterations=cfg.max_iterations,
        damping=cfg.damping, pref_scale=cfg.pref_scale, seed=cfg.seed)
    # two internal tiers collapse to one output level: each point's final
    # exemplar (its shard exemplar's top-level exemplar)
    return RawBackendResult(
        exemplars=res.exemplar_of[None, :], n_sweeps=cfg.max_iterations,
        converged=None, trace=None)


register_backend(BackendSpec(
    name="sharded_streaming", run=_streaming_run, needs_points=True,
    doc="two-tier shard-local AP; O((N/S)^2) state, single output level"))


def _coarsen_run(x, cfg: SolveConfig) -> RawBackendResult:
    from repro_torch.solver.coarsen import run_coarsen
    return run_coarsen(x, cfg)


register_backend(BackendSpec(
    name="coarsen", run=_coarsen_run, needs_points=True,
    supports_early_stop=True,
    doc="two-level kd-partition -> batched local dense solves -> global "
        "exemplar solve; O(partition_size^2 * batch) peak state"))
