"""Preference (self-similarity) strategies (port of ``repro/core/preferences.py``).

``random`` draws from a seeded ``torch.Generator``; it cannot reproduce the
``jax.random`` stream, so the same seed gives other numbers than the
reference.
"""
from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch import obs

Strategy = Literal["median", "range_mid", "random", "constant"]


def _off_diagonal(s: torch.Tensor) -> torch.Tensor:
    """The N*N - N off-diagonal entries, row-major, as a 1-D tensor.

    Dropping the first element of the flattened matrix leaves the diagonal
    at the end of every (N + 1)-wide row; no boolean mask is built.
    """
    n = s.shape[-1]
    return s.reshape(-1)[1:].reshape(n - 1, n + 1)[:, :-1].reshape(-1)


def median_preference(s: torch.Tensor) -> torch.Tensor:
    """Median of off-diagonal similarities (Frey & Dueck default): the mean
    of the two middle order statistics of the N*N - N entries (an even
    count; ``torch.median`` would return the lower one). Two ``kthvalue``
    selections, no sort and no sort indices."""
    n = s.shape[-1]
    vals = _off_diagonal(s)
    half = (n * n - n) // 2
    lo = torch.kthvalue(vals, half).values
    hi = torch.kthvalue(vals, half + 1).values
    return (0.5 * (lo + hi)).expand(n).clone()


def range_mid_preference(s: torch.Tensor) -> torch.Tensor:
    """(min + max)/2 of off-diagonal similarities (Givoni et al.)."""
    n = s.shape[-1]
    vals = _off_diagonal(s)
    return (0.5 * (vals.amin() + vals.amax())).expand(n).clone()


def random_preference(generator: torch.Generator, n: int,
                      low: float = -1.0e6, high: float = 0.0,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """Random negative preferences U[low, high] — the paper's choice (§4.1).

    Drawn on the generator's device, then moved, so a CPU generator gives
    the same numbers whatever ``device`` is."""
    u = torch.rand(n, generator=generator, dtype=dtype,
                   device=generator.device)
    return obs.to_device(low + (high - low) * u, device, "random_preference")


def make_preferences(
    s: torch.Tensor,
    strategy: Strategy = "median",
    *,
    generator: Optional[torch.Generator] = None,
    constant: float = 0.0,
    low: float = -1.0e6,
    high: float = 0.0,
) -> torch.Tensor:
    n = s.shape[-1]
    if strategy == "median":
        return median_preference(s)
    if strategy == "range_mid":
        return range_mid_preference(s)
    if strategy == "random":
        if generator is None:
            raise ValueError("random preferences need a torch.Generator")
        return random_preference(generator, n, low, high, s.dtype, s.device)
    if strategy == "constant":
        return torch.full((n,), constant, dtype=s.dtype, device=s.device)
    raise ValueError(f"unknown preference strategy: {strategy}")
