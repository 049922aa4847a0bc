from repro_torch.configs.base import (
    ArchConfig, ShapeConfig, SHAPES, applicable_shapes,
)
from repro_torch.configs.registry import ARCHS, arch_names, get_arch

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "applicable_shapes",
           "ARCHS", "arch_names", "get_arch"]
