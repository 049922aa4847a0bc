"""Arch config: xlstm-1.3b (see registry.py for the figures)."""
from repro_torch.configs.registry import xlstm_1_3b as CONFIG

SMOKE = CONFIG.reduced()
