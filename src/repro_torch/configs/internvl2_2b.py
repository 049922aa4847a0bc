"""Arch config: internvl2-2b (see registry.py for the figures)."""
from repro_torch.configs.registry import internvl2_2b as CONFIG

SMOKE = CONFIG.reduced()
