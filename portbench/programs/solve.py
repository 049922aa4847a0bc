"""The ``solve`` program: ``repro_torch.solver.solve`` on point sets.

Set-up makes the cell's pool of inputs from the seed, moves them to the
card as float32, and warms up with one ``solve()`` of the cell's own
shape (the kernels load, or on a checkout's first run build, into
``build/repro_torch_kernels/``). The window calls ``solve`` on the pool's
inputs in turn; a traced window opens the configuration's ``spans``
around the program's layers (``tracing.Spans``).

The comparison that decides ``correct``: every call of the window is
judged. The plain reference (``portbench.reference``) works out each pool
input's clustering from the points alone, once the window has closed, and
each call's answer is held to the one for its input. One number is
compared against the cell's limit (``portbench/cells/<cell>.json``):
``mismatch``, on the worst level of the worst call, the share of points
whose exemplar differs from the reference's. Equal exemplars give equal
cluster counts on every level. A call that raised, took another route
than the configuration's, or ran another number of sweeps is failed, and
a run with a failed call is not correct.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import loadgen, reference, tracing
from portbench.programs import worst
from portbench.reference import precision

CALL_SPAN = "solve"
NUMBERS = ("mismatch",)
#: the traced window records every host op: the program's own spans
#: (``repro_torch.obs``) are function-scope ops
HOST_OPS = True


def reference_config(cell) -> dict:
    """What the plain reference needs: the stated solve settings and the
    configuration's ``reference`` constants."""
    s = cell.solve
    return {**cell.config["reference"], "levels": s["levels"],
            "sweeps": s["max_iterations"], "damping": s["damping"],
            "preference": s["preference"], "k": s.get("k"),
            "seed": s.get("seed", 0)}


def shapes(cell, x) -> dict:
    return {"n": int(x.shape[0]), "d": int(x.shape[1]),
            "k": cell.solve.get("k"), "levels": cell.solve["levels"],
            "layout": cell.config["reference"]["layout"]}


def make_pool(cell, seed: int) -> list:
    """The cell's pool of host arrays (float32) for ``seed``."""
    return [np.ascontiguousarray(x, np.float32) for x in
            loadgen.make_pool(cell.data, cell.mix["pool"], seed)]


class Run:
    def __init__(self, cell, seed: int, dev: str, sync):
        from repro_torch.solver import solve

        self.cell = cell
        marks = [time.perf_counter()]
        self.pool = make_pool(cell, seed)
        marks.append(time.perf_counter())
        self.inputs = [torch.from_numpy(x).to(dev) for x in self.pool]
        sync()
        marks.append(time.perf_counter())
        overrides = {**cell.solve, "device": dev}

        def call(x):
            return solve(x, **overrides)

        self.call = call
        call(self.inputs[0])             # warm-up: the cell's own shape
        sync()
        marks.append(time.perf_counter())
        self.steps = list(zip(("inputs", "to the device", "warm-up solve"),
                              (b - a for a, b in zip(marks, marks[1:]))))

    def spans(self):
        return tracing.Spans(self.cell.config["spans"])

    def values(self, calls: list, window_s: float) -> dict:
        ok = [c for c in calls if c.error is None]
        if not ok:
            return {}
        times = [c.seconds for c in ok]
        v = {"solve_s": window_s / len(ok),
             "solve_p90_s": float(np.percentile(times, 90))}
        # the dense cells' own names for the same two readings, held to
        # a bound of their own (their runs spread far less)
        v["dense_solve_s"] = v["solve_s"]
        v["dense_solve_p90_s"] = v["solve_p90_s"]
        return v

    def counts(self, calls: list) -> tuple[int, dict]:
        sweeps = sum(c.result.n_sweeps for c in calls if c.error is None)
        return sweeps, shapes(self.cell, self.pool[0])

    def release(self) -> None:
        self.inputs = None


def gaps(exemplars: np.ndarray, ref: np.ndarray) -> dict:
    """The compared numbers of one answer against the reference's
    canonical exemplars ``ref`` (L, N)."""
    exemplars = np.asarray(exemplars)
    if exemplars.shape != ref.shape:
        return {"mismatch": 1.0}
    return {"mismatch": float((exemplars != ref).mean(axis=1).max())}


def failure(call, route: str, sweeps: int):
    """Why ``call`` counts as failed, or None."""
    if call.error is not None:
        return "raised"
    res = call.result
    if res.backend != route:
        return f"route {res.backend}, not {route}"
    if res.n_sweeps != sweeps:
        return f"{res.n_sweeps} sweeps, not {sweeps}"
    return None


def judge(cell, run, calls: list, device) -> dict:
    """-> {"correct", "failed", "compared", "numbers": {name: {"value",
    "limit"}}, "why"}."""
    cfg = reference_config(cell)
    failed, refs = [], {}
    worst = dict.fromkeys(NUMBERS, 0.0)
    for i, c in enumerate(calls):
        why = failure(c, cell.config["route"], cfg["sweeps"])
        if why is not None:
            failed.append(f"call {i}: {why}")
            continue
        if c.input_index not in refs:
            refs[c.input_index] = reference.decisions(
                cfg, run.pool[c.input_index], device)
        g = gaps(c.result.exemplars, refs[c.input_index])
        worst = {k: max(worst[k], g[k]) for k in NUMBERS}
    compared = len(calls) - len(failed)
    numbers = {k: {"value": worst[k], "limit": cell.limits[k]}
               for k in NUMBERS}
    within = all(v["value"] <= v["limit"] for v in numbers.values())
    return {"correct": bool(compared and not failed and within),
            "failed": len(failed), "compared": compared,
            "numbers": numbers, "why": failed[:5]}


def readings(cell, seed: int, program: bool, control: bool) -> dict:
    """One seed's line for ``calibrate.py``: each pool input solved once,
    as the window does, and the control, the reference computed at TF32
    (``reference.precision.tf32``), the nearest precision below the
    configuration's float32; each the worst over the pool."""
    from repro_torch.solver import solve

    cfg = reference_config(cell)
    overrides = {**cell.solve, "device": "cuda"}
    prog, ctl, t_ref, t_ctl = {}, {}, 0.0, 0.0
    for x in make_pool(cell, seed):
        t0 = time.perf_counter()
        ref = reference.decisions(cfg, x, "cuda")
        t_ref += time.perf_counter() - t0
        if program:
            res = solve(torch.from_numpy(x).cuda(), **overrides)
            bad = failure(loadgen.Call(0, 0.0, res, None),
                          cell.config["route"], cfg["sweeps"])
            if bad:
                raise RuntimeError(f"seed {seed}: {bad}")
            prog = worst(prog, gaps(res.exemplars, ref))
            del res
        if control:
            t0 = time.perf_counter()
            e = reference.decisions(cfg, x, "cuda", precision.tf32)
            t_ctl += time.perf_counter() - t0
            ctl = worst(ctl, gaps(e, ref))
        torch.cuda.empty_cache()
    line = {"seed": seed, "reference_s": t_ref, "control_s": t_ctl}
    if prog:
        line["program"] = prog
    if ctl:
        line["control"] = ctl
    return line
