"""Input families for the median-select kernel's tests (numpy only).

Shared by the CPU tests of its digit walk (``test_torch_kernels.py``) and
its card tests (``test_torch_cuda.py``, which imports no JAX).
"""
from __future__ import annotations

import numpy as np

KINDS = ("normal", "equal", "int_sqdist", "signed_zeros", "both_signs",
         "infinities", "split_top_digit", "split_middle_digit")

#: (shape, skip_diagonal): off-diagonal counts 2, 6, 110 and 4,032; whole
#: arrays of counts 2, 3, 15 (odd), 63 (odd) and 2,560
LAYOUTS = (((2, 2), True), ((3, 3), True), ((11, 11), True),
           ((64, 64), True), ((1, 2), False), ((1, 3), False),
           ((3, 5), False), ((7, 9), False), ((40, 64), False))


def _split(shape, skip_diagonal, below: float, above: float) -> np.ndarray:
    """``below`` on the first half of the counted entries (rounded up) and
    ``above`` on the rest, so that an even count's two middle order
    statistics are ``below`` and ``above``."""
    rows, cols = shape
    counted = np.ones(shape, bool)
    if skip_diagonal:
        counted[np.arange(rows), np.arange(cols)] = False
    order = np.cumsum(counted.ravel()).reshape(shape)
    x = np.where(order <= (counted.sum() + 1) // 2, below, above)
    return x.astype(np.float32)


def values(kind: str, shape, skip_diagonal: bool, seed: int) -> np.ndarray:
    """A float32 array of ``shape`` from one family, with a diagonal that
    would move the answer if it were counted."""
    rng = np.random.default_rng(seed)
    rows, cols = shape
    if kind == "normal":
        x = rng.standard_normal(shape)
    elif kind == "equal":
        x = np.full(shape, -7.25)
    elif kind == "int_sqdist":        # the Mandrill's kind: heavy ties
        pts = rng.integers(0, 6, (max(rows, cols), 3)).astype(np.float32)
        d2 = ((pts[:rows, None, :] - pts[None, :cols, :]) ** 2).sum(-1)
        x = -d2
    elif kind == "signed_zeros":
        x = np.where(rng.random(shape) < 0.5, 0.0, -0.0)
        x[rng.random(shape) < 0.1] = 1.0
    elif kind == "both_signs":
        x = (np.where(rng.random(shape) < 0.5, -1.0, 1.0)
             * 10.0 ** rng.uniform(-30, 30, shape))
    elif kind == "infinities":
        x = rng.standard_normal(shape)
        x[rng.random(shape) < 0.25] = np.inf
        x[rng.random(shape) < 0.25] = -np.inf
    elif kind == "split_top_digit":   # -1 and 1: other signs, other bins
        x = _split(shape, skip_diagonal, -1.0, 1.0)
    elif kind == "split_middle_digit":  # keys equal but for bit 11
        x = _split(shape, skip_diagonal, 1.0, 1.0 + 2.0 ** -12)
    else:
        raise ValueError(kind)
    x = np.asarray(x, np.float32)
    if skip_diagonal:
        x[np.arange(rows), np.arange(cols)] = np.inf
    return x
