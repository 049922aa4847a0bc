"""Arch config: granite-3-8b (see registry.py for the figures)."""
from repro_torch.configs.registry import granite_3_8b as CONFIG

SMOKE = CONFIG.reduced()
