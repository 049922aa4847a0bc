"""The one traffic generator: a pool of inputs from the seed, and a closed
loop with one caller.

The pool holds ``mix["pool"]`` inputs, input i drawn by the configuration's
generator (``portbench/datasets/<kind>.py``) from ``SeedSequence([seed,
i])``, so every seed gives the same sizes and only other values. Where
the parameters hold ``per_input``, a list of parameter sets, input i
takes the (i mod its length)-th over the others. The
caller sends the pool's inputs in turn, each once the previous call has
returned, until the window's seconds have passed: a user who waits for
each answer before sending the next.
"""
from __future__ import annotations

import importlib
import sys
import time
import traceback
from typing import Callable, NamedTuple, Optional

import numpy as np


class Call(NamedTuple):
    input_index: int
    seconds: float             # host clock, closed by a synchronize
    result: Optional[object]   # what the call returned
    error: Optional[str]       # why it failed, if it raised


def input_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([seed % 2 ** 64, i])
               .generate_state(1, np.uint64)[0])


def make_pool(data: dict, pool: int, seed: int) -> list:
    """``pool`` host arrays for ``seed``, in the generator's own dtype."""
    gen = importlib.import_module(f"portbench.datasets.{data['kind']}")
    each = data.get("per_input") or [{}]
    return [np.ascontiguousarray(gen.make({**data, **each[i % len(each)]},
                                          input_seed(seed, i)))
            for i in range(pool)]


def closed_loop(call: Callable, inputs: list, seconds: float,
                sync: Callable) -> tuple[list, float]:
    """Call ``call(inputs[i % len])`` back to back until ``seconds`` have
    passed at the end of a call; -> (calls, window seconds)."""
    calls = []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        try:
            res, err = call(inputs[i % len(inputs)]), None
            sync()
        except Exception:       # the loop reports every failed call
            res, err = None, traceback.format_exc()
            print(err, file=sys.stderr)
        t1 = time.perf_counter()
        calls.append(Call(i % len(inputs), t1 - t0, res, err))
        i += 1
        if t1 - start >= seconds:
            return calls, t1 - start
