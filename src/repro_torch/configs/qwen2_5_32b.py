"""Arch config: qwen2.5-32b (see registry.py for the figures)."""
from repro_torch.configs.registry import qwen25_32b as CONFIG

SMOKE = CONFIG.reduced()
