"""The comparison that decides ``correct`` must fail the control and a
broken program.

The control is the plain reference computed at TF32 (every step rounded
to 10 mantissa bits), the nearest precision below the configurations'
float32: held to the reference by each cell's own limit it has to come
out not correct. It did at the cells' own sizes on the card (PERF.md,
section 2); here it runs at a CPU size, on the cell's generator.

Each test drives a whole run of a cell cut to CPU size (``_tiny``), past
the harness's look for a card, with the timed path broken underneath,
and sees ``correct`` come out false. The faults a cell of this benchmark
can have: a sweep that returns its state unchanged; half of the rows left
out of each sweep's update; an answer altered where it is produced (the
solve's exemplars off by one point). No cell runs on more than one chip,
so none can leave out an exchange between chips.
"""
from __future__ import annotations

import importlib
import time

import numpy as np
import pytest
import torch

from portbench import _tiny, loadgen, reference, run, spec
from portbench.programs import solve as solve_program
from portbench.reference import precision

#: one cell a configuration: a configuration's cells share every fault site
CELLS = ["mandrill-dense.median", "blobs-200k-topk.d2"]


def unchanged(orig):
    def sweep(state, first_iter, **kw):
        return state
    return sweep


def half_rows(orig):
    def sweep(state, first_iter, **kw):
        new = orig(state, first_iter, **kw)
        h = state.r.shape[1] // 2
        return type(new)(*(torch.cat([n[:, :h], o[:, h:]], dim=1)
                           for n, o in zip(new, state)))
    return sweep


def altered(orig):
    def finalize(raw, n, backend):
        res = orig(raw, n, backend)
        e = res.exemplars.copy()
        e[0] = np.roll(e[0], 1)
        return res._replace(exemplars=e)
    return finalize


FAULTS = {
    "sweep_returns_its_state": ("repro_torch.core.hap", "jacobi_sweep",
                                unchanged),
    "half_the_rows_left_out": ("repro_torch.core.hap", "jacobi_sweep",
                               half_rows),
    "answer_altered": ("repro_torch.solver.engine", "_finalize", altered),
}


def judged(name: str) -> dict:
    out = run.run_cell(_tiny.tiny_cell(name), 2 ** 31 + 17, 0.0, False,
                       "cpu", time.perf_counter())
    return out["judged"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_program_is_not_correct(name, fault, monkeypatch):
    modname, attr, make = FAULTS[fault]
    mod = importlib.import_module(modname)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    j = judged(name)
    assert j["correct"] is False and j["failed"] == 0
    assert any(v["value"] > v["limit"] for v in j["numbers"].values())


#: CPU sizes at which the control reads well past each cell's limit
CONTROL_SIZES = {
    "blobs-200k-topk.d2": ({"n": 3000}, 64),
    "blobs-200k-topk.d128": ({"n": 2000}, 16),
    "mandrill-dense.median": ({"h": 24, "w": 24}, None),
    "mandrill-dense.random-pref": ({"h": 24, "w": 24}, None),
}


@pytest.mark.parametrize("name", sorted(CONTROL_SIZES))
def test_the_control_is_not_correct(name):
    cell = spec.find_cell(spec.load_benchmark(), name)
    data, k = CONTROL_SIZES[name]
    cfg = solve_program.reference_config(cell)
    if k is not None:
        cfg["k"] = k
    x = loadgen.make_pool({**cell.data, **data}, 1, 77)[0]
    ref = reference.decisions(cfg, x, "cpu")
    ctl = reference.decisions(cfg, x, "cpu", precision.tf32)
    assert solve_program.gaps(ctl, ref)["mismatch"] > cell.limits["mismatch"]
