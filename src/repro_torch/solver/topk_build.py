"""Top-k similarity build driver: backend selection and the sharded build
(port of ``repro/solver/topk_build.py``).

``build_topk_similarity`` resolves ``SolveConfig.build`` and returns the
``(vals (N, k), idx (N, k))`` layout. ``auto`` follows the reference's
rule, with "TPU" read as "CUDA" and "devices" as the ranks of the running
group: the sharded build in a group of several ranks from
``SHARDED_N`` points, the fused kernel on CUDA for neg-sqeuclidean, the
two-stage gated merge for big single-device builds (``TWOSTAGE_N <= N <=
SELECT_EXACT_MAX_N`` with ``4 k <= N``), the reference scan otherwise.
Every build selects the same edge set; the knob is throughput only.

``sharded_topk_similarity`` gives each rank of a 1-D ``workers`` mesh a
block of rows to build against the whole column set (and, for a two-stage
inner build, the same kd permutation), then gathers the blocks, so every
rank holds every row's list. Unlike the reference there is no degrade
fallback: on CUDA the fused build launches its kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_similarity import (
    SELECT_EXACT_MAX_N, kd_order, topk_similarity, topk_similarity_twostage,
)
from repro_torch.sharding.dist import all_gather, world_size
from repro_torch.solver.config import SolveConfig

#: every build backend; "auto" resolves to one of the rest
BUILD_BACKENDS = ("auto", "reference", "twostage", "fused", "sharded")

#: N from which a single-device build takes the two-stage gated merge
#: (the reference's crossover, measured on its CPU at k = 64).
TWOSTAGE_N = 32768

#: N at which a multi-device host switches to the sharded driver.
SHARDED_N = 8192


def resolve_build_backend(name: str, *, n: int, k: int,
                          metric: str = "neg_sqeuclidean",
                          n_devices: int = 1, platform: str = "cpu") -> str:
    """``cfg.build`` -> a concrete backend. ``platform`` is the device
    type of the points: "cuda" plays the reference's "tpu"."""
    if name not in BUILD_BACKENDS:
        raise ValueError(
            f"unknown build backend {name!r}; known: {BUILD_BACKENDS}")
    if name != "auto":
        return name
    if n_devices > 1 and n >= SHARDED_N:
        return "sharded"
    # the fused kernel is neg-sqeuclidean only; auto must never route a
    # metric it would reject
    if platform == "cuda" and metric == "neg_sqeuclidean":
        return "fused"
    # the two-stage gate needs headroom between k and N to prune, and its
    # exact tie-break keys cap N; otherwise the reference scan is optimal
    if TWOSTAGE_N <= n <= SELECT_EXACT_MAX_N and 4 * k <= n:
        return "twostage"
    return "reference"


def _local_build(x: torch.Tensor, k: int, cfg: SolveConfig, backend: str,
                 *, cols=None, row_offset: int = 0, perm=None):
    if backend == "twostage":
        return topk_similarity_twostage(
            x, k, metric=cfg.metric, block_rows=cfg.build_block_rows,
            chunk=cfg.build_chunk, cols=cols, row_offset=row_offset,
            perm=perm)
    if backend == "fused":
        if cfg.metric != "neg_sqeuclidean":
            raise ValueError(
                "build='fused' supports metric='neg_sqeuclidean' only; "
                f"got {cfg.metric!r} (use 'twostage' or 'reference')")
        from repro_torch.kernels.topk_build import topk_similarity_fused
        return topk_similarity_fused(x, k)
    return topk_similarity(
        x, k, metric=cfg.metric, block_rows=cfg.build_block_rows,
        block_cols=cfg.build_block_cols, cols=cols, row_offset=row_offset)


def sharded_topk_similarity(x: torch.Tensor, k: int, cfg: SolveConfig, *,
                            mesh=None, inner: str = "auto"):
    """Row-sharded top-k build over a 1-D ``workers`` mesh (default: the
    mesh ``solve`` would build, over every rank of the group).

    Rows are padded to a worker multiple and split; each rank builds its
    block against the whole column set (a two-stage inner build with the
    kd permutation of all points, the same on every rank), and the blocks
    are gathered, so every rank returns the whole ``(vals, idx)``, equal
    to the one-device builds'. The fused kernel is not a per-rank inner
    build (the reference scan takes its place, as in the reference), and
    a one-rank mesh runs the inner build alone."""
    if mesh is None:
        from repro_torch.solver.engine import prepare_mesh
        mesh, _ = prepare_mesh("1d", cfg)
    ax = mesh.axis("workers")
    n = int(x.shape[0])
    inner = resolve_build_backend(
        "auto" if inner in ("auto", "sharded") else inner,
        n=n, k=k, metric=cfg.metric, platform=x.device.type)
    if inner == "fused":
        inner = "reference"
    if ax.size == 1:
        return _local_build(x, k, cfg, inner)
    x = x.float()
    shard = -(-n // ax.size)
    block = torch.nn.functional.pad(x, (0, 0, 0, shard * ax.size - n))[
        ax.index * shard:(ax.index + 1) * shard]
    perm = (kd_order(x.cpu().numpy(), cfg.build_chunk)
            if inner == "twostage" else None)
    vals, idx = _local_build(block, k, cfg, inner, cols=x,
                             row_offset=ax.index * shard, perm=perm)
    return (all_gather(vals, ax, axis=0)[:n],
            all_gather(idx, ax, axis=0)[:n])


def build_topk_similarity(x: torch.Tensor, k: int, cfg: SolveConfig):
    """The build front door ``solver.topk`` calls: resolve the backend
    knob for the device ``x`` lies on and the group's rank count, run it,
    return the compressed off-diagonal layout."""
    n = int(x.shape[0])
    backend = resolve_build_backend(cfg.build, n=n, k=k, metric=cfg.metric,
                                    n_devices=world_size(),
                                    platform=x.device.type)
    if backend == "sharded":
        return sharded_topk_similarity(x, k, cfg)
    return _local_build(x, k, cfg, backend)
