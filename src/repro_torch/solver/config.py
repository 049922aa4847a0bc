"""Configuration for the solver engine (port of ``repro/solver/config.py``).

The same fields and defaults as the reference, plus ``device``. Fields of
backends that are not ported yet are kept (and validated at ``solve()``
entry) so a configuration means the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal, Optional

import numpy as np

InputKind = Literal["auto", "points", "similarity"]
StopRule = Literal["fixed", "converged"]

#: N at or above which auto-selection prefers the O((N/S)^2)-state
#: sharded-streaming backend over materializing the (L, N, N) tensors
#: (requires raw points).
STREAMING_THRESHOLD = 8192

#: N at or above which a multi-device host prefers the distributed
#: mr1d_stats backend over single-device dense sweeps.
DISTRIBUTED_THRESHOLD = 64

#: N at or above which auto-selection (points in hand, compatible
#: preference strategy) routes to the two-level ``coarsen`` backend —
#: past this size even the O(N*k) dense_topk state and its O(N)-columns
#: build become the wall, while coarsen's peak state is
#: O(partition_size^2 * batch) + O(E * k) for E ~ N/partition_size
#: local exemplars.
COARSEN_THRESHOLD = 500_000

#: Backends that take checkpoint/resume (``repro/solver/checkpointing.py``).
CHECKPOINT_BACKENDS = ("dense_topk", "coarsen")

#: Preference strategies that decompose over coarsen's partitions
#: (``repro/solver/coarsen.py``).
COARSEN_PREF_STRATEGIES = ("median", "range_mid")


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Everything ``repro_torch.solver.solve`` needs beyond the data itself.

    Stopping. ``stop="fixed"`` runs exactly ``max_iterations`` sweeps (the
    paper's figures use fixed budgets). ``stop="converged"`` runs until the
    exemplar assignment of every level is unchanged for ``patience``
    consecutive sweeps — the paper's (and Givoni et al.'s) "run until
    assignments are stable" rule — bounded by ``max_iterations``, inside a
    loop that reads the change count once per sweep.

    Input. ``input_kind="auto"`` treats a 3-D array as an (L, N, N)
    similarity stack, a square 2-D array as an (N, N) similarity matrix
    (replicated to ``levels``), and anything else 2-D as (N, d) points.
    When the engine builds similarities from points it also writes
    ``preference`` onto the diagonal; a similarity input's diagonal is the
    caller's responsibility and is never touched.
    """
    # backend selection ("auto" = pick from N, L, devices — see
    # repro_torch.solver.registry.auto_select)
    backend: str = "auto"

    # input interpretation
    input_kind: InputKind = "auto"
    levels: int = 3
    metric: str = "neg_sqeuclidean"
    # "median" | "range_mid" | float | (N,) array; applied only when the
    # engine builds the similarity matrix from points.
    preference: Any = "median"

    # message passing
    max_iterations: int = 50
    damping: float = 0.7
    kappa: float = 0.0
    s_mode: str = "off"

    # stopping rule
    stop: StopRule = "fixed"
    patience: int = 5

    # dense_topk: neighbors kept per row (excluding the self/preference
    # slot). None -> min(64, N-1); k = N-1 is full coverage, where the
    # sparse sweep reproduces dense_parallel exactly. solve() rejects
    # k < 1 and k >= N at entry (engine.validate_config). Memory is
    # O(L*N*k) against the dense O(L*N^2).
    k: Optional[int] = None

    # dense_topk similarity build (repro_torch.solver.topk_build). "auto"
    # resolves per problem/device: the CUDA fused kernel on the card,
    # the threshold-gated two-stage merge (not ported yet) for big
    # builds elsewhere, reference otherwise. Every backend produces the
    # identical edge set — this knob is throughput only.
    build: str = "auto"            # auto|reference|twostage|fused|sharded
    build_block_rows: int = 1024   # rows per build tile
    build_block_cols: int = 4096   # cols per reference/fused tile
    build_chunk: int = 128         # kd-cell width (two-stage/sharded gate)

    # dense_topk sweep execution (repro_torch.solver.topk_sharded).
    # "single" runs the whole Jacobi loop on one device; "sharded"
    # row-shards the (N, k+1) message layout over several devices (not
    # ported yet: solve() runs on one device, where it is "single").
    sweep: str = "auto"            # auto|single|sharded
    # column-statistics exchange for the sharded sweep: "allgather"
    # reproduces the single-device scatter order bit-for-bit (O(N*k)
    # gathered per level); "psum" all-reduces O(N) per-shard partial
    # column sums — the scalable mode, exact exemplar sets but
    # float-associativity ulps vs the oracle. "auto" = allgather until
    # the edge list outgrows ALLGATHER_MAX_ELEMS, then psum.
    exchange: str = "auto"         # auto|allgather|psum

    # distributed backends (mr1d_*, mr2d)
    mesh: Optional[Any] = None          # device mesh; auto-built when None
    pad_to: Optional[int] = None        # force-pad N to a multiple (tests)

    # dense_fused: the TPU kernels' tile size. The CUDA kernels choose
    # their own launch shapes and do not read it.
    block: int = 256

    # coarsen (two-level partition -> local dense solves -> global
    # exemplar solve). partition_size is the kd median-cut leaf: every
    # local solve is at most this many points (peak local state is
    # O(partition_size^2 * coarsen_batch)); coarsen_batch is how many
    # partitions one AOT-compiled BatchedDenseSolver call solves at
    # once; the global solve over the union of E local exemplars runs
    # dense_parallel while E <= coarsen_global_dense_n, else dense_topk
    # with k = min(coarsen_global_k, E - 1).
    partition_size: int = 256
    coarsen_batch: int = 8
    coarsen_global_dense_n: int = 4096
    coarsen_global_k: int = 64

    # graph_affinity (repro.graph): Borůvka-style affinity clustering
    # over an EdgeList (or the top-k graph built from points).
    # graph_rounds bounds the contraction rounds (None -> ceil(log2 N)+1,
    # enough to reach a single component); graph_target_clusters stops
    # the contraction once the cluster count is at or below it (None ->
    # run to connected components). Both are validated at solve() entry.
    graph_rounds: Optional[int] = None
    graph_target_clusters: Optional[int] = None
    # "graph" runs a cheap Borůvka pass over the built top-k edges and
    # seeds the HAP preference vector with it (graph-cluster leaders
    # keep the base preference, members pay a weight-span penalty).
    # Point input only; rejected for backends that cannot take a
    # per-point preference array (and for graph_affinity itself).
    preseed: str = "off"                # off|graph

    # checkpoint/resume (repro.solver.checkpointing; dense_topk and
    # coarsen only). checkpoint_every > 0 snapshots solve progress into
    # checkpoint_dir via repro.checkpoint: for dense_topk (single and
    # sweep="sharded") the compressed message state + sweep index every
    # that many sweeps; for coarsen, per-stage artifacts every that many
    # local batch groups plus one after the global solve, so a stage-3
    # crash resumes at stage 3. resume_from restarts from the newest
    # checkpoint in that directory, bit-exact with the uninterrupted
    # solve (same exemplars, same trace tail); the run's config/shape
    # key is validated against the checkpoint's sidecar metadata.
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    resume_from: Optional[str] = None

    # sharded_streaming
    shard_size: int = 512
    pref_scale: float = 1.0
    seed: int = 0

    # extras
    keep_state: bool = False            # attach final HAPState (dense only)

    # torch device the solve runs on; None means "cuda". solve() raises
    # when CUDA is missing rather than running on the CPU unasked.
    device: Optional[str] = None

    def replace(self, **kw) -> "SolveConfig":
        return dataclasses.replace(self, **kw)


def coarsen_pref_ok(preference) -> bool:
    """True iff ``preference`` decomposes over partitions: scalar or one
    of the supported strategy strings."""
    if preference is None:
        return True
    if isinstance(preference, str):
        return preference in COARSEN_PREF_STRATEGIES
    return np.ndim(preference) == 0
