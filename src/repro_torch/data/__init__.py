"""Seeded synthetic data (numpy copies of ``repro/data``)."""
from repro_torch.data.images import (
    buttons_image, image_to_points, mandrill_like_image,
)
from repro_torch.data.synth import aggregation_like, gaussian_blobs, two_moons

__all__ = ["aggregation_like", "buttons_image", "gaussian_blobs",
           "image_to_points", "mandrill_like_image", "two_moons"]
