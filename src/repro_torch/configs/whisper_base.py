"""Arch config: whisper-base (see registry.py for the figures)."""
from repro_torch.configs.registry import whisper_base as CONFIG

SMOKE = CONFIG.reduced()
