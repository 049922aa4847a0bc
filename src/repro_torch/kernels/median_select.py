"""Exact middle pair of an array and its mean: CUDA kernel and plain version.

Replaces no TPU kernel: the reference takes the median preference with
``jnp.sort`` (``src/repro/core/preferences.py:median_preference``,
``src/repro/solver/topk.py:topk_preferences``). The kernel is
``csrc/median_select.cu``: an exact radix select over the float32 bit
pattern in three digit passes, each a grid-wide histogram over the values
still in play, so the whole card reads the values (``torch.kthvalue``
hands a 1-D input to one thread block). It reads a square matrix in
place and skips its diagonal by index, writes three float32 on the device,
and adds no host sync. ``ref.middle_pair_by_digits`` states its digit walk
in plain PyTorch for the CPU tests.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import (
    _build, check_operands, on_cpu, ref, stream_of,
)

#: The plain PyTorch version: two ``torch.kthvalue`` selections.
plain = ref.middle_pair


def middle_pair(x: torch.Tensor, *, skip_diagonal: bool) -> torch.Tensor:
    """(lo, hi, 0.5 * (lo + hi)) of the values of a 2-D ``x`` (of its
    off-diagonal entries when ``skip_diagonal``, for a square ``x``), as a
    (3,) tensor on ``x``'s device. Of cnt values, lo and hi are those of
    1-based ranks (cnt - 1) // 2 + 1 and cnt // 2 + 1 as ``torch.kthvalue``
    ranks them, and equal its values under ``==`` (-0.0 and +0.0 rank
    alike; NaN ranks above +inf)."""
    if on_cpu("median_select", x):
        return plain(x, skip_diagonal=skip_diagonal)
    rows, cols = x.shape
    if skip_diagonal and rows != cols:
        raise ValueError(f"median_select: skip_diagonal needs a square "
                         f"matrix, got {tuple(x.shape)}")
    cnt = rows * cols - (rows if skip_diagonal else 0)
    if cnt <= 0:
        raise ValueError(f"median_select: no values in {tuple(x.shape)}")
    check_operands("median_select", x=(x, (rows, cols)))
    lib = _build.lib()
    scratch = torch.empty(lib.repro_median_select_scratch(),
                          dtype=torch.uint8, device=x.device)
    out = torch.empty(3, dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        err = lib.repro_median_select(
            x.data_ptr(), rows, cols, int(skip_diagonal), (cnt - 1) // 2,
            cnt // 2, sms, scratch.data_ptr(), out.data_ptr(), stream_of(x))
    _build.check(err, "median_select")
    obs.count("launches.median_select")
    return out
