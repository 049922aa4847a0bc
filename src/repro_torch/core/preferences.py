"""Preference (self-similarity) strategies (port of ``repro/core/preferences.py``).

``random`` draws from a seeded ``torch.Generator``; it cannot reproduce the
``jax.random`` stream, so the same seed gives other numbers than the
reference.
"""
from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch import obs
from repro_torch.kernels import median_select
from repro_torch.kernels.ref import off_diagonal

Strategy = Literal["median", "range_mid", "random", "constant"]


def middle_pair_preference(vals: torch.Tensor, n: int, *,
                           skip_diagonal: bool) -> torch.Tensor:
    """The median preference over a 2-D ``vals``, broadcast to (n,): the
    mean of its two middle order statistics (of an even count the two
    middle values; ``torch.median`` would return the lower one), over its
    off-diagonal entries when ``skip_diagonal`` (a dense S) or every value
    (the stored top-k values). One exact selection, the median-select
    kernel on the card."""
    mean = median_select.middle_pair(vals, skip_diagonal=skip_diagonal)[2]
    return mean.expand(n).clone()


def median_preference(s: torch.Tensor) -> torch.Tensor:
    """Median of off-diagonal similarities (Frey & Dueck default)."""
    return middle_pair_preference(s, s.shape[-1], skip_diagonal=True)


def range_mid_preference(s: torch.Tensor) -> torch.Tensor:
    """(min + max)/2 of off-diagonal similarities (Givoni et al.)."""
    n = s.shape[-1]
    vals = off_diagonal(s)
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
