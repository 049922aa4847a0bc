"""Arch config: tinyllama-1.1b (see registry.py for the figures)."""
from repro_torch.configs.registry import tinyllama_1_1b as CONFIG

SMOKE = CONFIG.reduced()
