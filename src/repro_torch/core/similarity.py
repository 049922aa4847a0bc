"""Similarity-matrix construction for (H)AP (port of ``repro/core/similarity.py``).

``s_ij = -||x_i - x_j||^2`` is the default metric; the diagonal holds the
preferences. Metrics keep the JAX formulas (one matmul per metric) so the
two packages round alike.
"""
from __future__ import annotations

from typing import Callable, Literal

import torch

Metric = Literal["neg_sqeuclidean", "neg_euclidean", "cosine"]

# Finite stand-in for the paper's "-inf" (low preference); keeps arithmetic
# NaN-free under +/- and damping.
NEG_LARGE = -1.0e9


def _neg_sqeuclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # ||x-y||^2 = ||x||^2 + ||y||^2 - 2 x.y, kept in this form (not
    # sum((x-y)^2)) to round like the reference.
    xx = (x * x).sum(dim=-1).unsqueeze(-1)
    yy = (y * y).sum(dim=-1).unsqueeze(-2)
    return -(xx + yy - 2.0 * (x @ y.T)).clamp_min(0.0)


def _neg_euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -torch.sqrt((-_neg_sqeuclidean(x, y)).clamp_min(1e-12))


def _cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xn = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)
    yn = y / (torch.linalg.norm(y, dim=-1, keepdim=True) + 1e-12)
    # cosine similarity in [-1, 1]; shift to <= 0 per the paper's convention.
    return xn @ yn.T - 1.0


_METRICS: dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "neg_sqeuclidean": _neg_sqeuclidean,
    "neg_euclidean": _neg_euclidean,
    "cosine": _cosine,
}


def pairwise_similarity(x: torch.Tensor,
                        metric: Metric = "neg_sqeuclidean") -> torch.Tensor:
    """Dense (N, N) similarity matrix, diagonal left at 0 (max preference)."""
    return _METRICS[metric](x, x)


def pairwise_similarity_blockwise(x: torch.Tensor,
                                  metric: Metric = "neg_sqeuclidean",
                                  block: int = 512) -> torch.Tensor:
    """The (N, N) similarity matrix built a row tile of ``block`` at a time,
    so each tile's temporaries take O(block * N): the paper's view of the
    similarity build as a map over row shards. The rows are zero-padded to
    a multiple of ``block`` and the padded rows dropped, as the
    reference's ``lax.map`` over tiles does."""
    n = x.shape[0]
    pad = (-n) % block
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    fn = _METRICS[metric]
    return torch.cat([fn(rows, x) for rows in xp.split(block)])[:n]


def set_preferences(s: torch.Tensor, pref) -> torch.Tensor:
    """A copy of ``s`` with the diagonal (preference) entries set to ``pref``
    (a scalar or an (N,) vector)."""
    n = s.shape[-1]
    out = s.clone()
    pref = torch.as_tensor(pref, dtype=s.dtype, device=s.device)
    out.diagonal().copy_(pref.expand(n))
    return out


def stack_levels(s: torch.Tensor, levels: int) -> torch.Tensor:
    """(N, N) -> (L, N, N): the paper replicates S across hierarchy levels.

    Materialised: an ``expand`` view aliases one buffer across levels, so
    an in-place write into one level would change all of them.
    """
    return s.unsqueeze(0).expand(levels, *s.shape).contiguous()
