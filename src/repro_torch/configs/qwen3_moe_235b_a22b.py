"""Arch config: qwen3-moe-235b-a22b (see registry.py for the figures)."""
from repro_torch.configs.registry import qwen3_moe as CONFIG

SMOKE = CONFIG.reduced()
