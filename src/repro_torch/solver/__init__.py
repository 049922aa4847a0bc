"""Solver engine of the port: one ``solve()`` API over the registered
backends (port of ``repro/solver``).

    from repro_torch.solver import solve, SolveConfig

    res = solve(points)                              # on "cuda"
    res = solve(points, device="cpu", stop="converged")
    res.exemplars, res.n_clusters, res.trace         # uniform result
"""
from repro_torch.solver.config import SolveConfig
from repro_torch.solver.engine import finalize_raw, solve, validate_config
from repro_torch.solver.registry import (
    BackendSpec, auto_select, get_backend, list_backends, register_backend,
)
from repro_torch.solver.result import RawBackendResult, SolveResult

__all__ = [
    "solve", "SolveConfig", "SolveResult", "RawBackendResult",
    "BackendSpec", "register_backend", "get_backend", "list_backends",
    "auto_select", "finalize_raw", "validate_config",
]
