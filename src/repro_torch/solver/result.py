"""The one result type every solver backend returns (port of
``repro/solver/result.py``; host-side arrays are numpy)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class SolveResult(NamedTuple):
    """Uniform output of ``repro_torch.solver.solve`` across all backends.

    ``exemplars[l, i]`` is the index of the point that point ``i`` selects
    as its exemplar at hierarchy level ``l`` (Eq 2.8, canonicalized one
    step so chains resolve to true exemplars). Padding dummies the engine
    added for mesh divisibility are already stripped: shapes are in the
    caller's original N.

    ``trace[t]`` is the number of per-point exemplar assignments (summed
    over levels) that changed in sweep ``t`` — the per-sweep convergence
    trace. Backends that run a fixed distributed schedule without
    assignment tracking return an empty trace.
    """
    exemplars: np.ndarray        # (L, N) int32, canonicalized
    n_clusters: np.ndarray       # (L,) int32
    labels: np.ndarray           # (L, N) int32 dense ids 0..k_l-1
    levels: int
    n: int
    backend: str
    n_sweeps: int                # sweeps actually executed
    converged: Optional[bool]    # None when stop="fixed" ran to budget
    trace: np.ndarray            # (n_sweeps,) int32 assignment changes
    state: Optional[object] = None   # HAPState (torch) when cfg.keep_state

    def level(self, l: int) -> np.ndarray:
        """Dense cluster labels of level ``l`` (convenience)."""
        return self.labels[l]


class RawBackendResult(NamedTuple):
    """What a backend adapter hands back to the engine (device-side,
    possibly still carrying padding dummies; the engine finishes the job:
    strip, canonicalize, relabel, count)."""
    exemplars: object            # (L, Npad) int array (torch or numpy)
    n_sweeps: int
    converged: Optional[bool]
    trace: Optional[object]      # (n_sweeps,) int array or None
    state: Optional[object] = None
