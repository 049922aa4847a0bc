"""Backend registry + automatic backend selection (port of
``repro/solver/registry.py``).

A backend is a function ``run(data, cfg) -> RawBackendResult`` plus the
capability flags the engine dispatches on. Every backend of the reference
is ported; ``get_backend`` raises ``KeyError`` for any other name, listing
the registered ones.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.solver.config import (
    COARSEN_THRESHOLD, DISTRIBUTED_THRESHOLD, STREAMING_THRESHOLD,
    SolveConfig, coarsen_pref_ok,
)
from repro_torch.solver.result import RawBackendResult


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str
    #: run(data, cfg) -> RawBackendResult, on an (L, N, N) float32
    #: similarity stack, on (N, d) points when ``needs_points`` or
    #: ``accepts_points``, or on an ``EdgeList`` when ``accepts_edges``.
    run: Callable[..., RawBackendResult]
    #: None (one process) | "1d" | "2d": the engine builds or validates the
    #: mesh over the group's ranks and pads N to its tile before ``run``
    mesh_kind: Optional[str] = None
    #: backend consumes raw points, not a similarity tensor
    needs_points: bool = False
    #: backend builds its own (possibly compressed) similarities from
    #: points; the engine hands it points when it has them, so the dense
    #: (N, N) matrix is never built on its account
    accepts_points: bool = False
    #: backend consumes a ``repro_torch.graph.EdgeList`` natively
    #: (compressed edge layout, no densification); backends without this
    #: flag get graph input through the engine's densify routing
    accepts_edges: bool = False
    #: backend honors cfg.stop == "converged"
    supports_early_stop: bool = False
    #: one-line description for docs/CLI listings
    doc: str = ""


_REGISTRY: Dict[str, BackendSpec] = {}


def register_backend(spec: BackendSpec) -> BackendSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"backend {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_backend(name: str) -> BackendSpec:
    # importing backends lazily avoids an import cycle
    from repro_torch.solver import backends as _  # noqa: F401  (registers)
    if name not in _REGISTRY:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown backend {name!r}; registered: {known}")
    return _REGISTRY[name]


def list_backends() -> Dict[str, BackendSpec]:
    from repro_torch.solver import backends as _  # noqa: F401
    return dict(_REGISTRY)


def auto_select(n: int, levels: int, *, n_devices: int, has_points: bool,
                platform: str, cfg: SolveConfig,
                has_edges: bool = False) -> str:
    """Pick a backend from problem size and hardware, by the reference's
    rules (``repro.solver.registry.auto_select``) with its TPU rule read as
    CUDA:

    1. an edge list -> ``graph_affinity``;
    2. points with N >= COARSEN_THRESHOLD and a partition-compatible
       preference -> ``coarsen``;
    3. points with N >= STREAMING_THRESHOLD -> ``sharded_streaming`` (one
       level, fixed budget) else ``dense_topk``;
    4. several ranks in the running group (``n_devices``) and N >=
       DISTRIBUTED_THRESHOLD (fixed budget) -> ``mr1d_stats``;
    5. one device: ``dense_fused`` on CUDA (the kernel hot path), else
       ``dense_parallel``.
    """
    if has_edges:
        return "graph_affinity"
    early = cfg.stop == "converged"
    if has_points and n >= COARSEN_THRESHOLD and coarsen_pref_ok(
            cfg.preference):
        return "coarsen"
    if has_points and n >= STREAMING_THRESHOLD:
        if levels == 1 and not early:
            return "sharded_streaming"
        return "dense_topk"
    if n_devices > 1 and n >= DISTRIBUTED_THRESHOLD and not early:
        return "mr1d_stats"
    if platform == "cuda":
        return "dense_fused"
    return "dense_parallel"
