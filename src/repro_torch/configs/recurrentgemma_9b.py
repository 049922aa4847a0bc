"""Arch config: recurrentgemma-9b (see registry.py for the figures)."""
from repro_torch.configs.registry import recurrentgemma_9b as CONFIG

SMOKE = CONFIG.reduced()
