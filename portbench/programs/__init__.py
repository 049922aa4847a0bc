"""The programs a configuration can run, one module a program.

A configuration's file names its program (``"program"``; absent, it is
``solve``), and ``run.py`` imports ``portbench/programs/<program>.py``
for the cell being run and no other, so a cell loads nothing of another
program's path. Each module defines:

- ``CALL_SPAN``: the name of the benchmark's span around each timed call
  in a traced window (``portbench.<CALL_SPAN>``).
- ``NUMBERS``: the numbers its judge compares, the keys of a cell's
  ``limits``.
- ``HOST_OPS``: whether a traced window records every host op, or only
  the spans and the runtime calls that launch kernels
  (``tracing.profile``).
- ``Run(cell, seed, dev, sync)``: the set-up of one run, warm-up
  included. It holds ``inputs`` (the closed loop's pool), ``call(x)``
  (the timed call), ``steps`` ([(label, seconds)] of the set-up, for the
  log), ``spans()`` (a context manager opened around a traced window,
  whose value has ``missing``: the layers whose entry point is absent),
  ``values(calls, window_s)`` (its end-to-end values by metric name),
  ``counts(calls)`` (-> (sweeps, shapes) for ``tracing.read``) and
  ``release()`` (frees what the judge does not need, once the peak is
  read).
- ``judge(cell, run, calls, dev)``: the comparison with the plain
  reference that decides ``correct``, -> {"correct", "failed",
  "compared", "numbers": {name: {"value", "limit"}}, "why"}.
- ``readings(cell, seed, program, control)``: one seed's readings of the
  program and of the control, for ``calibrate.py``.
"""
from __future__ import annotations

import importlib


def of(cell):
    """The program module of ``cell``."""
    return importlib.import_module(f"portbench.programs.{cell.program}")


def worst(a: dict, b: dict) -> dict:
    """The larger of each number of ``b`` and of ``a`` (0 where absent)."""
    return {k: max(a.get(k, 0.0), b[k]) for k in b}
