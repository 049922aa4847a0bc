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
graph_affinity     Borůvka min-edge/contract affinity clustering over
                   an EdgeList (or the built top-k graph); O(N*k) per
                   round, ~log N rounds
mr1d_stats         paper §3 MR-HAP over the group's ranks, 1-D row
                   sharding, O(L*N) statistics exchanged
mr1d_transpose     the same with the paper's distributed transposes,
                   O(L*N^2/W) exchanged
mr2d               2-D tile decomposition over a rows x cols mesh
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mrhap import run_mrhap, run_mrhap_2d
from repro_torch.core.streaming import streaming_hap
from repro_torch.graph.edges import EdgeList
from repro_torch.sharding.dist import world_size
from repro_torch.solver import dense, topk, topk_sharded
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


def _sweep_mesh(cfg: SolveConfig, n: int):
    """The 1-D ``workers`` mesh a sweep or round loop over ``n`` rows
    shards over, or None for the one-device loop: ``cfg.sweep`` resolved
    against the group's rank count, and a one-rank mesh detours to the
    one-device loop, the same arithmetic without the exchanges (the
    reference's detour)."""
    if topk_sharded.resolve_sweep(cfg.sweep, n=n,
                                  n_devices=world_size()) != "sharded":
        return None
    from repro_torch.solver.engine import prepare_mesh
    mesh, _ = prepare_mesh("1d", cfg)
    return mesh if mesh.shape["workers"] > 1 else None


def _topk_run(data, cfg: SolveConfig) -> RawBackendResult:
    """Compressed-layout Jacobi sweeps; O(L*N*k) state instead of
    O(L*N^2). Takes raw points (the top-k build; the N x N matrix is never
    built), an (L, N, N) similarity stack (row-wise compression), or an
    ``EdgeList`` (already the compressed layout — dedup + pad, never
    densify). ``checkpoint_every``/``resume_from`` run the sweeps in
    checkpointed segments (``solver.checkpointing``)."""
    if isinstance(data, EdgeList):
        el = data.without_self_loops().deduplicated()
        n = el.n_nodes
        # an edge list brings its own sparsity: keep every stored edge
        # unless cfg.k asks for a tighter (weight desc, dst asc) cut
        k = (topk.resolve_k(cfg.k, n) if cfg.k is not None
             else max(1, min(el.max_degree, n - 1)))
        vals, idx_off = el.to_topk(k)
        pref = el.edge_preferences(
            cfg.preference if cfg.preference is not None else "median",
            seed=cfg.seed)
        device = torch.device(cfg.device or "cuda")
        s_rows, idx = topk._with_self_slot(
            *(torch.from_numpy(a).to(device) for a in (vals, idx_off, pref)))
        s3k = s_rows.expand(cfg.levels, *s_rows.shape).contiguous()
    elif data.ndim == 3:
        n = data.shape[1]
        s3k, idx = topk.compress_stack(data, topk.resolve_k(cfg.k, n))
    else:
        n = data.shape[0]
        s3k, idx = topk.build_from_points(
            data, topk.resolve_k(cfg.k, n), cfg.levels,
            metric=cfg.metric, preference=cfg.preference, seed=cfg.seed,
            config=cfg)

    mesh = _sweep_mesh(cfg, n)
    if cfg.checkpoint_every > 0 or cfg.resume_from:
        from repro_torch.solver import checkpointing
        state, e, n_sweeps, conv, trace = \
            checkpointing.run_topk_checkpointed(s3k, idx, cfg, mesh=mesh)
    elif mesh is not None:
        state, e, n_sweeps, conv, trace = topk_sharded.run_topk_sharded(
            s3k, idx, mesh, max_iterations=cfg.max_iterations,
            damping=cfg.damping, kappa=cfg.kappa, s_mode=cfg.s_mode,
            stop=cfg.stop, patience=cfg.patience, exchange=cfg.exchange)
    else:
        state, e, n_sweeps, conv, trace = topk.run_topk(
            s3k, idx, max_iterations=cfg.max_iterations, damping=cfg.damping,
            kappa=cfg.kappa, s_mode=cfg.s_mode, stop=cfg.stop,
            patience=cfg.patience)
    if mesh is not None and cfg.keep_state:
        state = topk_sharded.gather_state(state, mesh)
    return RawBackendResult(
        exemplars=e, n_sweeps=n_sweeps,
        converged=bool(conv) if cfg.stop == "converged" else None,
        trace=trace[:n_sweeps], state=state if cfg.keep_state else None)


register_backend(BackendSpec(
    name="dense_topk", run=_topk_run, accepts_points=True,
    accepts_edges=True, supports_early_stop=True,
    doc="top-k-per-row sparse similarities; O(L*N*k) state, exact at "
        "k=N-1"))


def _graph_run(data, cfg: SolveConfig) -> RawBackendResult:
    """Borůvka-style affinity clustering (``repro_torch.graph.affinity``).
    Takes an ``EdgeList`` natively; points go through the top-k build
    first (the fused kernel on the card), a similarity stack through row
    compression of level 0 — in every case the directed top-k graph is
    canonicalized (self-loops dropped, symmetrized, deduplicated) on the
    host, then contracted on ``cfg.device``. ``cfg.sweep`` routes the round
    loop to one device or row-sharded over the group's ranks; the two are
    bit-identical."""
    from repro_torch.graph import affinity
    from repro_torch.kernels.topk_similarity import topk_from_dense

    if isinstance(data, EdgeList):
        el = data
    elif data.ndim == 3:
        vals, idx = topk_from_dense(data[0], topk.resolve_k(cfg.k,
                                                            data.shape[-1]))
        el = EdgeList.from_topk(vals.cpu().numpy(), idx.cpu().numpy())
    else:
        el = EdgeList.from_points(
            data, topk.resolve_k(cfg.k, data.shape[0]), config=cfg)
    el = el.canonical()
    vals, idx = el.to_topk()
    device = torch.device(cfg.device or "cuda")
    hist, r, conv, trace = affinity.run_graph_affinity(
        torch.from_numpy(vals).to(device), torch.from_numpy(idx).to(device),
        levels=cfg.levels, max_rounds=cfg.graph_rounds,
        target=cfg.graph_target_clusters or 1,
        mesh=_sweep_mesh(cfg, el.n_nodes))
    return RawBackendResult(
        exemplars=hist, n_sweeps=r, converged=bool(conv),
        trace=np.asarray(trace)[:r], state=None)


register_backend(BackendSpec(
    name="graph_affinity", run=_graph_run, accepts_points=True,
    accepts_edges=True, supports_early_stop=True,
    doc="Borůvka min-edge/contract affinity clustering over an edge "
        "list; O(N*k) per round, ~log N rounds"))


def _mr1d_runner(comm_mode: str):
    def run(s3, cfg: SolveConfig) -> RawBackendResult:
        res = run_mrhap(s3, cfg.mesh, iterations=cfg.max_iterations,
                        damping=cfg.damping, comm_mode=comm_mode)
        return RawBackendResult(
            exemplars=res.exemplars, n_sweeps=cfg.max_iterations,
            converged=None, trace=None)
    return run


register_backend(BackendSpec(
    name="mr1d_stats", run=_mr1d_runner("stats"), mesh_kind="1d",
    doc="1-D row sharding, O(L*N) statistics communication"))

register_backend(BackendSpec(
    name="mr1d_transpose", run=_mr1d_runner("transpose"), mesh_kind="1d",
    doc="paper-faithful distributed transposes, O(L*N^2/W) communication"))


def _mr2d_run(s3, cfg: SolveConfig) -> RawBackendResult:
    res = run_mrhap_2d(s3, cfg.mesh, iterations=cfg.max_iterations,
                       damping=cfg.damping)
    return RawBackendResult(
        exemplars=res.exemplars, n_sweeps=cfg.max_iterations,
        converged=None, trace=None)


register_backend(BackendSpec(
    name="mr2d", run=_mr2d_run, mesh_kind="2d",
    doc="2-D tile decomposition over rows x cols mesh axes"))


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
