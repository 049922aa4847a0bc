"""What the run ran on: the device block of the result line, read from
torch, and the card's power limit and clocks from ``nvidia-smi`` (a card
may be set below its 700 W, and then runs slower under load)."""
from __future__ import annotations

import subprocess

import torch

SMI_FIELDS = ("name", "power.limit", "clocks.sm", "clocks.max.sm",
              "temperature.gpu")


def available(chips: int) -> str | None:
    """None when this process sees ``chips`` CUDA cards, else why not."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"{torch.cuda.device_count()} CUDA device(s), the cell "
                f"asks for {chips}")
    return None


def block(count: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def smi() -> dict:
    """The first card's ``nvidia-smi`` readings, or why there are none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": f"nvidia-smi: {e}"}
    first = out.stdout.strip().splitlines()[0]
    return dict(zip(SMI_FIELDS, (v.strip() for v in first.split(","))))
