"""HAP core (port of ``repro/core``): similarities, preferences, flat AP,
the HAP message passing, its MapReduce parallelization over the ranks of a
``torch.distributed`` group (``mrhap``), and host-side assignment
post-processing.

The preferred entry point is ``repro_torch.solver.solve`` (also reachable
here as ``solve``): one API over every backend, with routing, mesh set-up,
padding and early stopping. ``run_hap``, ``run_mrhap``, ``run_mrhap_2d``
and ``streaming_hap`` are the backends' bodies without that care.
"""
from repro_torch.core.affinity import (
    APResult,
    affinity_propagation,
    availability_update,
    masked_top2,
    net_similarity,
    responsibility_update,
)
from repro_torch.core.assignments import (
    Hierarchy, canonicalize, link_hierarchy,
)
from repro_torch.core.hap import HAPResult, HAPState, extract_exemplars, run_hap
from repro_torch.core.metrics import nmi, purity
from repro_torch.core.mrhap import (
    MRHAPResult,
    comm_bytes_per_iteration,
    pad_similarity,
    run_mrhap,
    run_mrhap_2d,
)
from repro_torch.core.preferences import make_preferences
from repro_torch.core.similarity import (
    pairwise_similarity,
    pairwise_similarity_blockwise,
    set_preferences,
    stack_levels,
)
from repro_torch.core.streaming import converged_ap, streaming_hap

_SOLVER_EXPORTS = ("solve", "SolveConfig", "SolveResult")


def __getattr__(name):
    # lazy: repro_torch.solver imports repro_torch.core's modules, so an
    # eager re-export would be circular for callers importing solver first
    if name in _SOLVER_EXPORTS:
        import repro_torch.solver as _solver
        return getattr(_solver, name)
    raise AttributeError(
        f"module 'repro_torch.core' has no attribute {name!r}")


__all__ = [
    "APResult", "affinity_propagation", "availability_update", "masked_top2",
    "net_similarity", "responsibility_update", "Hierarchy", "canonicalize",
    "link_hierarchy", "HAPResult", "HAPState", "extract_exemplars", "run_hap",
    "nmi", "purity", "MRHAPResult", "comm_bytes_per_iteration",
    "pad_similarity", "run_mrhap", "run_mrhap_2d", "make_preferences",
    "converged_ap", "streaming_hap", "pairwise_similarity",
    "pairwise_similarity_blockwise", "set_preferences", "stack_levels",
    "solve", "SolveConfig", "SolveResult",
]
