"""Procedural images standing in for the paper's "Mandrill" (103x103) and
"Buttons" (120x100) segmentation inputs (§4.1). No network access, so the
images are generated: same sizes, comparable color statistics (a multi-hue
organic texture and a grid of colored discs).

A copy of ``repro/data/images.py``; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import numpy as np


def mandrill_like_image(h: int = 103, w: int = 103, seed: int = 0) -> np.ndarray:
    """Organic multi-hue texture (RGB uint8, (h, w, 3)) — mandrill analogue:
    a few dominant color regions (red/blue/yellow zones) + fine texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    yn, xn = yy / h, xx / w
    # smooth region fields (low-frequency sinusoids)
    f1 = np.sin(3.1 * xn + 1.7) * np.cos(2.3 * yn)
    f2 = np.cos(4.2 * xn * yn + 0.5) + np.sin(2.9 * yn)
    r = 0.55 + 0.4 * f1
    g = 0.45 + 0.35 * np.sin(5.0 * (xn - 0.5) ** 2 + 3.0 * yn)
    b = 0.5 + 0.45 * f2 * 0.5
    img = np.stack([r, g, b], axis=-1)
    img += 0.06 * rng.standard_normal(img.shape)  # fine fur-like texture
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def buttons_image(h: int = 100, w: int = 120, seed: int = 1) -> np.ndarray:
    """Grid of colored discs on a gray background — buttons analogue."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 0.82)
    palette = np.array([
        [0.85, 0.1, 0.1], [0.1, 0.5, 0.9], [0.95, 0.8, 0.1],
        [0.2, 0.7, 0.3], [0.6, 0.2, 0.7], [0.9, 0.5, 0.1],
    ])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    k = 0
    for cy in range(12, h, 25):
        for cx in range(14, w, 28):
            rad = 9 + rng.integers(0, 3)
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= rad ** 2
            color = palette[k % len(palette)] * (0.85 + 0.3 * rng.random())
            img[mask] = np.clip(color, 0, 1)
            k += 1
    img += 0.02 * rng.standard_normal(img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def image_to_points(img: np.ndarray, subsample: int = 1) -> np.ndarray:
    """Flatten HxWx3 uint8 -> (N, 3) float32 RGB vectors (paper treats RGB
    intensities as the feature vectors)."""
    x = img.astype(np.float32).reshape(-1, 3)
    return x[::subsample]
