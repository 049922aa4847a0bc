"""Top-k similarity build driver: backend selection (port of
``repro/solver/topk_build.py``).

``build_topk_similarity`` resolves ``SolveConfig.build`` and returns the
``(vals (N, k), idx (N, k))`` layout. ``auto`` picks the fused kernel on
CUDA for neg-sqeuclidean (the reference's TPU rule, with "TPU" read as
"CUDA"), else the reference scan; where the reference's rule would pick
the two-stage build, which is not ported, it picks the reference scan too.
Every build selects the same edge set; the knob is throughput only.

What the port does without, for now (``ROADMAP.md`` queue A):

* no degrade fallback: on CUDA the fused build launches its kernel or
  raises; it never drops to the reference scan;
* ``build="twostage"`` (the kd-gated merge) raises ``NotImplementedError``;
* ``build="sharded"``: ``solve`` runs on one device, where the reference's
  sharded driver short-circuits to its inner build, and so does this one.

``resolve_build_backend`` keeps the reference's ``n_devices`` rule and
``SHARDED_N`` so the tests can hold the routing table against the
reference's; ``solve`` always passes one device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_similarity import topk_similarity
from repro_torch.solver.config import SolveConfig

#: every build backend; "auto" resolves to one of the rest
BUILD_BACKENDS = ("auto", "reference", "twostage", "fused", "sharded")

#: N from which the reference's single-device build off its accelerator
#: takes the two-stage gated merge (its measured crossover); the port's
#: auto keeps the reference scan there until that build is ported.
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
    # the reference takes the two-stage build for
    # TWOSTAGE_N <= n <= SELECT_EXACT_MAX_N and 4 k <= n; it is not ported,
    # and the reference scan selects the same edges, so auto stays here
    return "reference"


def _local_build(x: torch.Tensor, k: int, cfg: SolveConfig, backend: str):
    if backend == "twostage":
        raise NotImplementedError(
            "build='twostage' (the kd-gated two-stage merge) is not ported "
            "yet; see ROADMAP.md queue A. Use build='reference', or "
            "build='fused' on CUDA")
    if backend == "fused":
        if cfg.metric != "neg_sqeuclidean":
            raise ValueError(
                "build='fused' supports metric='neg_sqeuclidean' only; "
                f"got {cfg.metric!r} (use 'reference')")
        from repro_torch.kernels.topk_build import topk_similarity_fused
        return topk_similarity_fused(x, k)
    return topk_similarity(
        x, k, metric=cfg.metric, block_rows=cfg.build_block_rows,
        block_cols=cfg.build_block_cols)


def build_topk_similarity(x: torch.Tensor, k: int, cfg: SolveConfig):
    """The build front door ``solver.topk`` calls: resolve the backend
    knob for the device ``x`` lies on, run it, return the compressed
    off-diagonal layout."""
    n = int(x.shape[0])
    platform = x.device.type
    backend = resolve_build_backend(cfg.build, n=n, k=k, metric=cfg.metric,
                                    platform=platform)
    if backend == "sharded":
        # the reference's one-device short-circuit: its inner build, with
        # the fused kernel replaced by the reference scan
        backend = resolve_build_backend("auto", n=n, k=k, metric=cfg.metric,
                                        platform=platform)
        if backend == "fused":
            backend = "reference"
    return _local_build(x, k, cfg, backend)
