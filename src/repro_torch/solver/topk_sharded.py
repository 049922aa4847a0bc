"""Sweep-execution and exchange modes of ``dense_topk`` (the resolvers of
``repro/solver/topk_sharded.py``).

Only the mode names, the resolvers and their constants are ported. The
engine validates ``SolveConfig.sweep``/``exchange`` against the names;
the resolvers and thresholds are a routing table that the tests hold
against the reference's, and nothing in ``solve`` calls them: ``solve``
runs on one device, where every sweep mode runs the single-device loop
(the reference's own detour for a one-worker mesh). The row-sharded sweep
and its exchanges come with the distributed slice (``ROADMAP.md`` queue
A.7).
"""
from __future__ import annotations

#: every sweep-execution mode; "auto" resolves per problem/host
SWEEP_MODES = ("auto", "single", "sharded")

#: column-exchange strategies for the sharded sweep
EXCHANGE_MODES = ("auto", "allgather", "psum")

#: N at which a multi-device host switches the sweeps to the sharded driver
SHARDED_SWEEP_N = 32768

#: padded edge count (N * (k + 1)) above which "auto" takes the O(N) psum
#: exchange over the O(N * k) allgather
ALLGATHER_MAX_ELEMS = 1 << 24


def resolve_sweep(name: str, *, n: int, n_devices: int = 1) -> str:
    """``cfg.sweep`` -> "single" | "sharded" for this problem/host."""
    if name not in SWEEP_MODES:
        raise ValueError(
            f"unknown sweep mode {name!r}; known: {SWEEP_MODES}")
    if name != "auto":
        return name
    if n_devices > 1 and n >= SHARDED_SWEEP_N:
        return "sharded"
    return "single"


def resolve_exchange(name: str, *, n: int, kk: int) -> str:
    """``cfg.exchange`` -> a concrete exchange for this layout."""
    if name not in EXCHANGE_MODES:
        raise ValueError(
            f"unknown exchange mode {name!r}; known: {EXCHANGE_MODES}")
    if name != "auto":
        return name
    return "allgather" if n * kk <= ALLGATHER_MAX_ELEMS else "psum"
