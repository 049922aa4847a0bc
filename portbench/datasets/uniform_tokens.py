"""Prompts of token ids drawn uniformly over the vocabulary: ``make``
gives a (batch, prompt_len) int64 array of ids in [0, vocab)."""
from __future__ import annotations

import numpy as np


def make(params: dict, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, params["vocab"],
                        size=(params["batch"], params["prompt_len"]),
                        dtype=np.int64)
