"""The comparison that decides ``correct``.

Every call of the window is judged: the plain reference
(``portbench.reference``) works out each pool input's clustering from the
points alone, once the window has closed, and each call's answer is held
to the one for its input. One number is compared against the cell's
limit (``portbench/cells/<cell>.json``): ``mismatch``, on the worst level
of the worst call, the share of points whose exemplar differs from the
reference's. Equal exemplars give equal cluster counts on every level.
A call that raised, took another route than the configuration's, or ran
another number of sweeps is failed, and a run with a failed call is not
correct.
"""
from __future__ import annotations

import numpy as np

from portbench import reference

NUMBERS = ("mismatch",)


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


def judge(cell, pool: list, calls: list, device) -> dict:
    """-> {"correct", "failed", "compared", "numbers": {name: {"value",
    "limit"}}, "why"}."""
    cfg = cell.reference_config()
    failed, refs = [], {}
    worst = dict.fromkeys(NUMBERS, 0.0)
    for i, c in enumerate(calls):
        why = failure(c, cell.config["route"], cfg["sweeps"])
        if why is not None:
            failed.append(f"call {i}: {why}")
            continue
        if c.input_index not in refs:
            refs[c.input_index] = reference.decisions(
                cfg, pool[c.input_index], device)
        g = gaps(c.result.exemplars, refs[c.input_index])
        worst = {k: max(worst[k], g[k]) for k in NUMBERS}
    compared = len(calls) - len(failed)
    numbers = {k: {"value": worst[k], "limit": cell.limits[k]}
               for k in NUMBERS}
    within = all(v["value"] <= v["limit"] for v in numbers.values())
    return {"correct": bool(compared and not failed and within),
            "failed": len(failed), "compared": compared,
            "numbers": numbers, "why": failed[:5]}
