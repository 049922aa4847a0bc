"""Arch config: mixtral-8x22b (see registry.py for the figures)."""
from repro_torch.configs.registry import mixtral_8x22b as CONFIG

SMOKE = CONFIG.reduced()
