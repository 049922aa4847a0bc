"""Spans and counters of the solve path, in one place.

``span(name)`` opens ``repro_torch.<name>`` in a ``torch.profiler`` trace
while one records, and is one shared no-op otherwise: no knob, no
environment variable, and no span synchronises. A span is a CPU op of the
trace (the profiler's function scope, not the user scope of
``torch.profiler.record_function``), so it has no device-side shadow
range: the device timeline holds only what ran there. Kernels are matched
to the spans they were launched in by the profiler's correlation ids.

``count``, ``counters`` and ``reset_counters`` keep one dict of counts
under one lock; they are always on. The solve path counts:

* ``solves``: ``solve()`` calls, whose number the ``solve`` span carries
  as its ``call`` argument (shown when the profiler records shapes);
* ``launches.<kernel>``: launches of each hand-written kernel
  (``kernels.launch_counts`` is a view of them);
* ``host_copies.<site>``: each pass through ``to_host`` or ``to_device``,
  the explicit copies between host and device; on a card each one is a
  copy, and a copy to the host waits for the device.
"""
from __future__ import annotations

import contextlib
import threading

import torch

PREFIX = "repro_torch."

_LOCK = threading.Lock()
_COUNTS: dict[str, int] = {}
_OFF = contextlib.nullcontext()


def span(name: str, call: int | None = None):
    """``repro_torch.<name>`` as a context manager while a profiler
    records; ``call`` numbers a ``solve`` span's call."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    kwargs = {} if call is None else {"call": call}
    return torch._C._profiler._RecordFunctionFast(PREFIX + name, [], kwargs)


def count(name: str, n: int = 1) -> int:
    """Add ``n`` to counter ``name``; -> its new value."""
    with _LOCK:
        value = _COUNTS[name] = _COUNTS.get(name, 0) + n
    return value


def counters() -> dict[str, int]:
    """A copy of every counter."""
    with _LOCK:
        return dict(_COUNTS)


def reset_counters(prefix: str = "") -> None:
    """Drop the counters whose names start with ``prefix`` (all of them by
    default)."""
    with _LOCK:
        for name in [k for k in _COUNTS if k.startswith(prefix)]:
            del _COUNTS[name]


def to_host(t: torch.Tensor, site: str) -> torch.Tensor:
    """``t`` on the host, counted as ``host_copies.<site>``."""
    count("host_copies." + site)
    return t.cpu()


def to_device(t: torch.Tensor, device, site: str) -> torch.Tensor:
    """``t`` on ``device``, counted as ``host_copies.<site>``."""
    count("host_copies." + site)
    return t.to(device)
