"""MoE expert-affinity analysis: HAP over router statistics (port of
``repro/core/expert_affinity.py``).

Router probabilities over a token batch define a co-activation signature
per expert; AP clusters experts by signature similarity WITHOUT presetting
a cluster count — redundant experts (experts the router treats
interchangeably) surface as multi-member clusters, informing expert-merge
or capacity decisions. A pure analysis hook on router probabilities; it
runs on ``device`` (None means CUDA, and a missing CUDA raises) unless
given a tensor, which runs where it is.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.affinity import affinity_propagation
from repro_torch.core.assignments import canonicalize
from repro_torch.core.similarity import pairwise_similarity, set_preferences
from repro_torch.solver.engine import as_points


class ExpertClusters(NamedTuple):
    labels: np.ndarray       # (E,) cluster id per expert
    exemplars: np.ndarray    # (E,) exemplar expert per expert
    n_clusters: int
    redundancy: float        # 1 - n_clusters / E


def expert_signatures(router_probs, device: Optional[str] = None
                      ) -> torch.Tensor:
    """(T, E) -> (E, T') normalized co-activation signatures (T' <= 4096)."""
    p = as_points(router_probs, device)
    t = min(p.shape[0], 4096)
    sig = p[:t].T                                   # (E, T')
    return sig / (torch.linalg.norm(sig, dim=1, keepdim=True) + 1e-9)


def cluster_experts(
    router_probs, *, iterations: int = 100, damping: float = 0.7,
    preference_scale: float = 1.0, device: Optional[str] = None,
) -> ExpertClusters:
    sig = expert_signatures(router_probs, device)
    e = sig.shape[0]
    s = pairwise_similarity(sig)
    off = s.cpu().numpy()[~np.eye(e, dtype=bool)]
    pref = float(np.median(off)) * preference_scale
    # Frey & Dueck's degeneracy tiebreak: interchangeable experts produce
    # exactly symmetric messages (both stay self-exemplars forever); a
    # deterministic jitter ~1e-6 of the similarity scale breaks the saddle
    # without moving any non-degenerate decision. The reference's numpy
    # draw, so the same jitter.
    jitter_rng = np.random.default_rng(e)
    jitter = (1e-6 * max(float(np.abs(off).mean()), 1e-12)
              * jitter_rng.standard_normal(tuple(s.shape)).astype(np.float32))
    s = s + torch.from_numpy(np.asarray(jitter, np.float32)).to(s.device)
    s = set_preferences(s, pref)
    res = affinity_propagation(s, iterations=iterations, damping=damping)
    ex = canonicalize(res.exemplars.cpu().numpy())
    uniq, labels = np.unique(ex, return_inverse=True)
    return ExpertClusters(labels.astype(np.int32), ex, len(uniq),
                          1.0 - len(uniq) / e)
