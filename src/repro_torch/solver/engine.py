"""``solve()`` — the front door of the port (port of ``repro/solver/engine.py``).

    from repro_torch.solver import solve
    res = solve(points)                        # auto backend, on "cuda"
    res = solve(points, device="cpu")          # plain PyTorch on the CPU
    res = solve(points, stop="converged")      # run until assignments stable

The engine normalizes the input ((N, d) points, an (N, N) similarity, an
(L, N, N) stack, or a ``repro_torch.graph.EdgeList``), selects a backend,
builds the similarity (with the CUDA similarity kernel on the fused path)
and the preferences — or hands the points to a backend that builds its
own (``dense_topk``, ``graph_affinity``, ``sharded_streaming``,
``coarsen``), the edge list to a backend that takes one natively
(``graph_affinity``, ``dense_topk``) or its densified matrix to the rest —
and finishes the backend's raw result. Unlike the reference it has no
degrade chain: a kernel that fails to build or launch raises.

In a ``torch.distributed`` group (one process per worker, started by
``torchrun`` or ``sharding.dist.spawn``) every rank calls ``solve`` with
the same input and gets the same result: the routing counts the group's
ranks, the MR backends run over a mesh of them (``prepare_mesh``), and the
top-k build and sweep shard their rows over it.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.assignments import canonicalize_levels, dense_labels
from repro_torch.core.mrhap import pad_similarity
from repro_torch.core.preferences import make_preferences
from repro_torch.core.similarity import (
    pairwise_similarity, set_preferences, stack_levels,
)
from repro_torch.graph.edges import EdgeList
from repro_torch.launch.mesh import factor_2d, make_mesh, make_worker_mesh
from repro_torch.sharding.dist import maybe_init_distributed, world_size
from repro_torch.solver.config import CHECKPOINT_BACKENDS, SolveConfig
from repro_torch.solver.registry import auto_select, get_backend
from repro_torch.solver.result import RawBackendResult, SolveResult
from repro_torch.solver.topk_build import BUILD_BACKENDS
from repro_torch.solver.topk_sharded import EXCHANGE_MODES, SWEEP_MODES


# ------------------------------------------------------------- validation
def validate_config(cfg: SolveConfig, n: int) -> None:
    """Reject invalid knob combinations at the front door, with the
    problem size in hand, with the reference's messages."""
    if cfg.k is not None:
        if cfg.k < 1:
            raise ValueError(
                f"SolveConfig.k must be >= 1 (got k={cfg.k})")
        if cfg.k >= n:
            raise ValueError(
                f"SolveConfig.k must be < N (got k={cfg.k}, N={n}); "
                "k = N - 1 already stores every off-diagonal entry "
                "(full coverage)")
    if cfg.patience < 0:
        raise ValueError(
            f"SolveConfig.patience must be >= 0 (got {cfg.patience})")
    if cfg.max_iterations < 1:
        raise ValueError(
            "SolveConfig.max_iterations must be >= 1 "
            f"(got {cfg.max_iterations})")
    if cfg.build not in BUILD_BACKENDS:
        raise ValueError(
            f"SolveConfig.build must be one of {BUILD_BACKENDS}; "
            f"got {cfg.build!r}")
    if cfg.build_block_rows < 1 or cfg.build_block_cols < 1 \
            or cfg.build_chunk < 1:
        raise ValueError(
            "SolveConfig.build_block_rows/build_block_cols/build_chunk "
            f"must be >= 1 (got {cfg.build_block_rows}/"
            f"{cfg.build_block_cols}/{cfg.build_chunk})")
    if cfg.sweep not in SWEEP_MODES:
        raise ValueError(
            f"SolveConfig.sweep must be one of {SWEEP_MODES}; "
            f"got {cfg.sweep!r}")
    if cfg.exchange not in EXCHANGE_MODES:
        raise ValueError(
            f"SolveConfig.exchange must be one of {EXCHANGE_MODES}; "
            f"got {cfg.exchange!r}")
    if cfg.graph_rounds is not None and cfg.graph_rounds < 1:
        raise ValueError(
            "SolveConfig.graph_rounds must be >= 1 "
            f"(got {cfg.graph_rounds}); None lets the backend run "
            "ceil(log2 N) + 1 contraction rounds")
    if (cfg.graph_target_clusters is not None
            and cfg.graph_target_clusters < 1):
        raise ValueError(
            "SolveConfig.graph_target_clusters must be >= 1 "
            f"(got {cfg.graph_target_clusters}); None runs the "
            "contraction to connected components")
    if cfg.preseed not in ("off", "graph"):
        raise ValueError(
            "SolveConfig.preseed must be 'off' or 'graph'; "
            f"got {cfg.preseed!r}")
    if cfg.checkpoint_every < 0:
        raise ValueError(
            "SolveConfig.checkpoint_every must be >= 0 "
            f"(got {cfg.checkpoint_every}); 0 disables checkpointing")
    if cfg.checkpoint_every > 0 and not cfg.checkpoint_dir:
        raise ValueError(
            "SolveConfig.checkpoint_every > 0 needs checkpoint_dir to "
            "write the snapshots into")
    if cfg.backend == "coarsen":
        from repro_torch.solver.coarsen import check_coarsen_config
        check_coarsen_config(cfg)


# ------------------------------------------------------------------ input
def resolve_device(device=None) -> torch.device:
    """``device`` (``SolveConfig.device``, or the ``device`` argument of a
    function that takes numpy arrays) as a torch device; None means CUDA,
    and a missing CUDA raises instead of falling back to the CPU."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return device


def as_points(x, device=None) -> torch.Tensor:
    """``x`` as float32 points for the analysis functions that take numpy
    or tensors (baselines, curation): a tensor stays on its device, numpy
    input goes to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        resolve_device(device))


def _normalize_input(data, cfg: SolveConfig, device: torch.device):
    """-> (points, similarity stack, edge list, original N) — exactly one
    of the first three is not None; points and stacks are float32 tensors
    on ``device``, an edge list stays on the host."""
    if isinstance(data, EdgeList):
        return None, None, data, data.n_nodes
    arr = data if isinstance(data, torch.Tensor) else np.asarray(data)
    shape = tuple(arr.shape)

    def to_device(a):
        if not isinstance(a, torch.Tensor):
            a = obs.to_device(torch.from_numpy(np.array(a, dtype=np.float32)),
                              device, "input")
        return a.to(device=device, dtype=torch.float32)

    if arr.ndim == 3:
        if shape[1] != shape[2]:
            raise ValueError(f"3-D input must be (L, N, N); got {shape}")
        if cfg.input_kind == "points":
            raise ValueError("input_kind='points' requires a 2-D (N, d) array")
        return None, to_device(arr), None, shape[1]
    if arr.ndim != 2:
        raise ValueError(f"expected 2-D or 3-D input; got ndim={arr.ndim}")
    kind = cfg.input_kind
    if kind == "auto":
        kind = "similarity" if shape[0] == shape[1] else "points"
    if kind == "similarity":
        if shape[0] != shape[1]:
            raise ValueError(f"similarity matrix must be square; {shape}")
        return None, stack_levels(to_device(arr), cfg.levels), None, shape[0]
    return to_device(arr), None, None, shape[0]


def _densify_edges(el: EdgeList, cfg: SolveConfig, device: torch.device):
    """EdgeList -> (L, N, N) stack for backends without native edge
    support: missing entries take the inert fill (strictly below every
    stored weight), the diagonal takes ``cfg.preference`` resolved over
    the stored edge weights (``None`` means "median" here, as in the
    reference)."""
    pref = cfg.preference if cfg.preference is not None else "median"
    s = set_preferences(
        torch.from_numpy(el.to_dense()).to(device),
        torch.from_numpy(el.edge_preferences(pref, seed=cfg.seed)).to(device))
    return stack_levels(s, cfg.levels)


def _build_similarity(x: torch.Tensor, cfg: SolveConfig, backend: str):
    """Points -> (L, N, N) stack with preferences on the diagonal."""
    with obs.span("build"):
        if backend == "dense_fused" and cfg.metric == "neg_sqeuclidean":
            from repro_torch.kernels import ops
            s = ops.neg_sqeuclidean(x)
        else:
            s = pairwise_similarity(x, metric=cfg.metric)
        pref = cfg.preference
        if pref is None and cfg.preseed != "graph":
            return stack_levels(s, cfg.levels)
        if isinstance(pref, str):
            gen = torch.Generator().manual_seed(cfg.seed)
            with obs.span("preference"):
                pref = make_preferences(s, pref, generator=gen)
        if cfg.preseed == "graph":
            # seed the preference vector from a cheap Borůvka pass over the
            # matrix's top-k graph (the matrix already exists, so compressing
            # it costs no extra build)
            from repro_torch.graph.affinity import preseed_preferences
            from repro_torch.kernels.topk_similarity import topk_from_dense
            from repro_torch.solver.topk import resolve_k
            vals, idx = topk_from_dense(s, resolve_k(cfg.k, s.shape[0]))
            pref = preseed_preferences(
                vals, idx, 0.0 if pref is None else pref,
                target=cfg.graph_target_clusters, max_rounds=cfg.graph_rounds)
        return stack_levels(set_preferences(s, pref), cfg.levels)


# ------------------------------------------------------------------ solve
def solve(data, config: Optional[SolveConfig] = None,
          **overrides: Any) -> SolveResult:
    """Cluster ``data`` hierarchically with the configured backend.

    ``data``: (N, d) points, (N, N) similarity matrix (diagonal =
    preferences, caller-owned) or (L, N, N) per-level similarity stack, as
    a numpy array or a tensor, or a ``repro_torch.graph.EdgeList`` (routed
    natively to edge-capable backends, densified with inert fill for the
    rest). Keyword overrides patch ``config`` field by field:
    ``solve(x, backend="dense_fused", max_iterations=80)``.
    """
    with obs.span("solve", call=obs.count("solves")):
        return _solve(data, config, overrides)


def _solve(data, config: Optional[SolveConfig], overrides: dict
           ) -> SolveResult:
    with obs.span("prepare"):
        cfg = config or SolveConfig()
        if overrides:
            cfg = cfg.replace(**overrides)
        device = resolve_device(cfg.device)
        cfg = cfg.replace(device=str(device))
        # a launch that torchrun's environment describes joins its group
        # before routing counts the ranks; in one process a no-op
        maybe_init_distributed(device)

        x, s3, el, n = _normalize_input(data, cfg, device)
        validate_config(cfg, n)

        backend = cfg.backend
        if backend == "auto":
            backend = route(n, x is not None, device, cfg,
                            has_edges=el is not None)
        spec = get_backend(backend)

        if cfg.checkpoint_every > 0 or cfg.resume_from:
            if backend not in CHECKPOINT_BACKENDS:
                raise ValueError(
                    f"checkpoint/resume is supported by {CHECKPOINT_BACKENDS} "
                    f"(the long-running paths), not backend {backend!r}; drop "
                    "checkpoint_every/resume_from or pick a supported backend")
        if spec.needs_points and x is None:
            hint = (" — an EdgeList carries no point coordinates"
                    if el is not None else "")
            raise ValueError(
                f"backend {backend!r} clusters raw points (it never builds "
                "the global similarity matrix); pass an (N, d) "
                f"array{hint}")
        if cfg.stop == "converged" and not spec.supports_early_stop:
            raise ValueError(
                f"backend {backend!r} runs a fixed distributed sweep schedule "
                "and does not support stop='converged'; use stop='fixed' or a "
                "dense backend")
        if cfg.preseed == "graph":
            if backend == "graph_affinity":
                raise ValueError(
                    "preseed='graph' seeds a HAP backend's preferences with a "
                    "graph pass; backend='graph_affinity' IS the graph pass — "
                    "drop one of the two")
            if x is None:
                raise ValueError(
                    "preseed='graph' re-derives preferences from the top-k "
                    "graph the engine builds; it requires (N, d) point input")
            if spec.needs_points:
                raise ValueError(
                    f"backend {backend!r} does not consume a per-point "
                    "preference array, which is what preseed='graph' "
                    "produces; use a dense or dense_topk backend")

    if el is not None and spec.accepts_edges:
        raw = spec.run(el, cfg)
    elif spec.needs_points or (spec.accepts_points and x is not None):
        # points backends (sharded_streaming, coarsen, dense_topk,
        # graph_affinity) build their own similarities, and the dense
        # N x N matrix is never built here
        raw = spec.run(x, cfg)
    else:
        if s3 is None:
            s3 = (_densify_edges(el, cfg, device) if el is not None
                  else _build_similarity(x, cfg, backend))
        if spec.mesh_kind:
            mesh, multiple = prepare_mesh(spec.mesh_kind, cfg)
            s3, _ = pad_similarity(s3, multiple)
            cfg = cfg.replace(mesh=mesh)
        raw = spec.run(s3, cfg)
    return _finalize(raw, n, backend)


def route(n: int, has_points: bool, device: torch.device,
          cfg: SolveConfig, has_edges: bool = False) -> str:
    """The backend ``backend="auto"`` runs. It counts the ranks of the
    running ``torch.distributed`` group as the reference counts devices: a
    plain process counts one, however many cards its host has (each rank
    runs on one card)."""
    return auto_select(n, cfg.levels, n_devices=world_size(),
                       has_points=has_points, platform=device.type, cfg=cfg,
                       has_edges=has_edges)


# ------------------------------------------------------------------- mesh
def prepare_mesh(kind: str, cfg: SolveConfig):
    """-> (mesh, pad multiple) for distributed execution over the group's
    ranks: ``cfg.mesh`` if set, else a 1-D ``workers`` mesh (``"1d"``) or a
    ``rows`` x ``cols`` mesh of ``factor_2d`` (``"2d"``); the multiple
    includes ``cfg.pad_to``."""
    mesh = cfg.mesh
    if kind == "1d":
        if mesh is None:
            mesh = make_worker_mesh()
        if tuple(mesh.axis_names) != ("workers",):
            raise ValueError(
                "mr1d backends need a 1-D mesh with axis 'workers' "
                f"(got axes {tuple(mesh.axis_names)}); build one with "
                "repro_torch.launch.mesh.make_worker_mesh()")
        multiple = mesh.shape["workers"]
    else:
        if mesh is None:
            mesh = make_mesh(factor_2d(world_size()), ("rows", "cols"))
        if tuple(mesh.axis_names) != ("rows", "cols"):
            raise ValueError(
                "mr2d needs a 2-D mesh with axes ('rows', 'cols') "
                f"(got axes {tuple(mesh.axis_names)})")
        multiple = math.lcm(mesh.shape["rows"], mesh.shape["cols"])
    if cfg.pad_to:
        multiple = math.lcm(multiple, cfg.pad_to)
    return mesh, multiple


def finalize_raw(raw: RawBackendResult, n: int, backend: str) -> SolveResult:
    """Turn a backend's raw output into a ``SolveResult`` (strip padding,
    canonicalize, relabel)."""
    return _finalize(raw, n, backend)


def _finalize(raw: RawBackendResult, n: int, backend: str) -> SolveResult:
    """Strip padding dummies, canonicalize, relabel, count clusters."""
    with obs.span("finalize"):
        e = raw.exemplars
        if isinstance(e, torch.Tensor):
            e = obs.to_host(e, "finalize").numpy()
        e = canonicalize_levels(np.asarray(e)[:, :n])
        levels = e.shape[0]
        labels = np.zeros_like(e, dtype=np.int32)
        counts = np.zeros((levels,), np.int32)
        for l in range(levels):
            labels[l], counts[l] = dense_labels(e[l])
        trace = (np.asarray(raw.trace, dtype=np.int32) if raw.trace is not None
                 else np.zeros((0,), np.int32))
        return SolveResult(
            exemplars=e.astype(np.int32), n_clusters=counts, labels=labels,
            levels=levels, n=n, backend=backend, n_sweeps=int(raw.n_sweeps),
            converged=raw.converged, trace=trace, state=raw.state)
