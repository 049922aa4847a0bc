"""Hand-written CUDA kernels of the HAP hot path (``repro_torch/csrc``).

Each kernel module holds a wrapper and, beside it, the kernel's plain
PyTorch version (``plain``). A wrapper runs the plain version only for
CPU tensors; for CUDA tensors it launches its kernel or raises — there is
no fallback. Every launch adds one to the module's ``launches`` count,
through ``count_launch``: the serving path launches from several worker
threads, and one lock keeps their increments from being lost.
"""
from __future__ import annotations

import importlib
import threading

import torch

KERNELS = ("similarity", "responsibility", "availability", "topk_build",
           "flash_attention")


def _module(name: str):
    return importlib.import_module(f"repro_torch.kernels.{name}")


_COUNT_LOCK = threading.Lock()


def count_launch(kernel: str) -> None:
    """Add one to ``repro_torch.kernels.<kernel>.launches``; every
    wrapper calls it where it launches its kernel, and nowhere else."""
    module = _module(kernel)
    with _COUNT_LOCK:
        module.launches += 1


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    with _COUNT_LOCK:
        return {name: _module(name).launches for name in KERNELS}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in KERNELS:
            _module(name).launches = 0


def on_cpu(kernel: str, *tensors: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (take the plain version);
    False when every operand lies on one CUDA device (launch the kernel).
    Anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: operands on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {device}")
    return False


def check_operands(kernel: str, **shapes) -> None:
    """Check the operands of a CUDA launch: f32, contiguous, and of the
    shapes given as ``name=(tensor, expected_shape)``."""
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be float32 on CUDA, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
