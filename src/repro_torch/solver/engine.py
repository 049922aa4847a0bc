"""``solve()`` — the front door of the port (port of ``repro/solver/engine.py``).

    from repro_torch.solver import solve
    res = solve(points)                        # auto backend, on "cuda"
    res = solve(points, device="cpu")          # plain PyTorch on the CPU
    res = solve(points, stop="converged")      # run until assignments stable

The engine normalizes the input ((N, d) points, an (N, N) similarity or an
(L, N, N) stack), selects a backend, builds the similarity (with the CUDA
similarity kernel on the fused path) and the preferences — or hands the
points to a backend that builds its own (``dense_topk``) — and finishes
the backend's raw result. Unlike the reference it has no degrade chain: a
kernel that fails to build or launch raises.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.assignments import canonicalize_levels, dense_labels
from repro_torch.core.preferences import make_preferences
from repro_torch.core.similarity import (
    pairwise_similarity, set_preferences, stack_levels,
)
from repro_torch.solver.config import (
    CHECKPOINT_BACKENDS, COARSEN_PREF_STRATEGIES, SolveConfig,
    coarsen_pref_ok,
)
from repro_torch.solver.registry import auto_select, get_backend
from repro_torch.solver.result import RawBackendResult, SolveResult
from repro_torch.solver.topk_build import BUILD_BACKENDS
from repro_torch.solver.topk_sharded import EXCHANGE_MODES, SWEEP_MODES


# ------------------------------------------------------------- validation
def _check_coarsen_config(cfg: SolveConfig) -> None:
    if cfg.partition_size < 2:
        raise ValueError(
            f"SolveConfig.partition_size must be >= 2 "
            f"(got {cfg.partition_size})")
    if cfg.coarsen_batch < 1:
        raise ValueError(
            f"SolveConfig.coarsen_batch must be >= 1 "
            f"(got {cfg.coarsen_batch})")
    if cfg.coarsen_global_dense_n < 2 or cfg.coarsen_global_k < 1:
        raise ValueError(
            "SolveConfig.coarsen_global_dense_n must be >= 2 and "
            f"coarsen_global_k >= 1 (got {cfg.coarsen_global_dense_n}/"
            f"{cfg.coarsen_global_k})")
    if not coarsen_pref_ok(cfg.preference):
        raise ValueError(
            "the coarsen backend's batched local solves support "
            f"preference in {COARSEN_PREF_STRATEGIES} or a scalar; got "
            f"{cfg.preference!r} (draw 'random' host-side and pass the "
            "scalar; per-point arrays don't decompose over partitions)")


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
        _check_coarsen_config(cfg)


# ------------------------------------------------------------------ input
def _resolve_device(cfg: SolveConfig) -> torch.device:
    """``cfg.device`` as a torch device; None means CUDA, and a missing
    CUDA raises instead of falling back to the CPU."""
    device = torch.device(cfg.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return device


def _normalize_input(data, cfg: SolveConfig, device: torch.device):
    """-> (points, similarity stack, original N) — exactly one of the
    first two is not None; both are float32 tensors on ``device``."""
    if all(hasattr(data, f) for f in ("src", "dst", "weight", "n_nodes")):
        raise NotImplementedError(
            "edge-list input comes with the graph slice (ROADMAP.md queue A "
            "item 6); pass (N, d) points or a similarity matrix")
    arr = data if isinstance(data, torch.Tensor) else np.asarray(data)
    shape = tuple(arr.shape)

    def to_device(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, dtype=np.float32))
        return a.to(device=device, dtype=torch.float32)

    if arr.ndim == 3:
        if shape[1] != shape[2]:
            raise ValueError(f"3-D input must be (L, N, N); got {shape}")
        if cfg.input_kind == "points":
            raise ValueError("input_kind='points' requires a 2-D (N, d) array")
        return None, to_device(arr), shape[1]
    if arr.ndim != 2:
        raise ValueError(f"expected 2-D or 3-D input; got ndim={arr.ndim}")
    kind = cfg.input_kind
    if kind == "auto":
        kind = "similarity" if shape[0] == shape[1] else "points"
    if kind == "similarity":
        if shape[0] != shape[1]:
            raise ValueError(f"similarity matrix must be square; {shape}")
        return None, stack_levels(to_device(arr), cfg.levels), shape[0]
    return to_device(arr), None, shape[0]


def _build_similarity(x: torch.Tensor, cfg: SolveConfig, backend: str):
    """Points -> (L, N, N) stack with preferences on the diagonal."""
    if backend == "dense_fused" and cfg.metric == "neg_sqeuclidean":
        from repro_torch.kernels import ops
        s = ops.neg_sqeuclidean(x)
    else:
        s = pairwise_similarity(x, metric=cfg.metric)
    pref = cfg.preference
    if pref is None:
        return stack_levels(s, cfg.levels)
    if isinstance(pref, str):
        gen = torch.Generator().manual_seed(cfg.seed)
        pref = make_preferences(s, pref, generator=gen)
    return stack_levels(set_preferences(s, pref), cfg.levels)


# ------------------------------------------------------------------ solve
def solve(data, config: Optional[SolveConfig] = None,
          **overrides: Any) -> SolveResult:
    """Cluster ``data`` hierarchically with the configured backend.

    ``data``: (N, d) points, (N, N) similarity matrix (diagonal =
    preferences, caller-owned) or (L, N, N) per-level similarity stack, as
    a numpy array or a tensor. Keyword overrides patch ``config`` field by
    field: ``solve(x, backend="dense_fused", max_iterations=80)``.
    """
    cfg = config or SolveConfig()
    if overrides:
        cfg = cfg.replace(**overrides)
    device = _resolve_device(cfg)

    x, s3, n = _normalize_input(data, cfg, device)
    validate_config(cfg, n)

    backend = cfg.backend
    if backend == "auto":
        backend = route(n, x is not None, device, cfg)
    spec = get_backend(backend)

    if cfg.checkpoint_every > 0 or cfg.resume_from:
        if backend not in CHECKPOINT_BACKENDS:
            raise ValueError(
                f"checkpoint/resume is supported by {CHECKPOINT_BACKENDS} "
                f"(the long-running paths), not backend {backend!r}; drop "
                "checkpoint_every/resume_from or pick a supported backend")
    if cfg.stop == "converged" and not spec.supports_early_stop:
        raise ValueError(
            f"backend {backend!r} runs a fixed distributed sweep schedule "
            "and does not support stop='converged'; use stop='fixed' or a "
            "dense backend")
    if cfg.preseed == "graph":
        if x is None:
            raise ValueError(
                "preseed='graph' re-derives preferences from the top-k "
                "graph the engine builds; it requires (N, d) point input")
        raise NotImplementedError(
            "preseed='graph' needs the graph and top-k modules, which are "
            "not ported yet")

    if spec.accepts_points and x is not None:
        # points-capable backend (dense_topk): it builds its own compressed
        # similarities, and the dense N x N matrix is never built here
        return _finalize(spec.run(x, cfg), n, backend)
    if s3 is None:
        s3 = _build_similarity(x, cfg, backend)
    return _finalize(spec.run(s3, cfg), n, backend)


def route(n: int, has_points: bool, device: torch.device,
          cfg: SolveConfig) -> str:
    """The backend ``backend="auto"`` runs. ``solve`` places everything on
    the one device ``cfg.device`` names, so the routing counts one device
    whatever the host has: the multi-device backends and the sharded
    build and sweep are not ported yet (``ROADMAP.md`` queue A item 8)."""
    return auto_select(n, cfg.levels, n_devices=1, has_points=has_points,
                       platform=device.type, cfg=cfg)


def finalize_raw(raw: RawBackendResult, n: int, backend: str) -> SolveResult:
    """Turn a backend's raw output into a ``SolveResult`` (strip padding,
    canonicalize, relabel)."""
    return _finalize(raw, n, backend)


def _finalize(raw: RawBackendResult, n: int, backend: str) -> SolveResult:
    """Strip padding dummies, canonicalize, relabel, count clusters."""
    e = raw.exemplars
    if isinstance(e, torch.Tensor):
        e = e.cpu().numpy()
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
