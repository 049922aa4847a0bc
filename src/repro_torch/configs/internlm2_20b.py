"""Arch config: internlm2-20b (see registry.py for the figures)."""
from repro_torch.configs.registry import internlm2_20b as CONFIG

SMOKE = CONFIG.reduced()
