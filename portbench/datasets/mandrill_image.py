"""The paper's §4.1 segmentation input: a 103 x 103 RGB "Mandrill" image
as (N, 3) points of its pixels' intensities.

The original image cannot be fetched, so it is generated: a frozen copy of
the repository's ``data/images.py`` (``mandrill_like_image``, then
``image_to_points``), kept here so that a change there does not move the
benchmark's inputs.
"""
from __future__ import annotations

import numpy as np


def mandrill_like_image(h: int, w: int, seed: int) -> np.ndarray:
    """Organic multi-hue texture (RGB uint8, (h, w, 3)): a few dominant
    colour regions and fine texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    yn, xn = yy / h, xx / w
    f1 = np.sin(3.1 * xn + 1.7) * np.cos(2.3 * yn)
    f2 = np.cos(4.2 * xn * yn + 0.5) + np.sin(2.9 * yn)
    r = 0.55 + 0.4 * f1
    g = 0.45 + 0.35 * np.sin(5.0 * (xn - 0.5) ** 2 + 3.0 * yn)
    b = 0.5 + 0.45 * f2 * 0.5
    img = np.stack([r, g, b], axis=-1)
    img += 0.06 * rng.standard_normal(img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def make(params: dict, seed: int) -> np.ndarray:
    img = mandrill_like_image(params["h"], params["w"], seed)
    return img.astype(np.float32).reshape(-1, 3)
