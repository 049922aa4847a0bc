"""Shared helpers of the port's training tests (``test_torch_train``,
``test_torch_train_step``): one train step of each package from the same
parameters (``tests/_torch_lm.py``'s ``Pair``) and the moment measure.

``moment_err`` takes each leaf's gap relative to max(its largest |value|,
``NOISE_FLOOR`` x the tree's largest). The floor is for leaves whose true
gradient is 0: a key projection's bias shifts every logit of a query
alike, which the softmax ignores, so its gradient is rounding noise
(~1e-11 where others are ~1e-2), and two summation orders' noise differs
wholly.
"""
from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import Mode as RefMode
from repro.train.loop import (
    init_train_state as ref_init_state, make_train_step as ref_make_step,
)
from repro_torch.models import Mode
from repro_torch.train import make_train_step
from repro_torch.train.loop import init_train_state

NOISE_FLOOR = 1e-3
LR = {"peak": 1e-3, "warmup": 0, "total": 10}


def moment_err(got, want) -> float:
    """Largest gap over the leaves of two equally shaped trees (numpy or
    tensors), each relative to max(its largest |value|, NOISE_FLOOR x the
    tree's largest)."""
    a = [np.asarray(x) for x in jax.tree.leaves(got)]
    b = [np.asarray(y) for y in jax.tree.leaves(want)]
    top = max(float(np.abs(y).max()) for y in b)
    return max(float(np.abs(x - y).max())
               / max(float(np.abs(y).max()), NOISE_FLOOR * top)
               for x, y in zip(a, b))


def ref_step(pair, inputs: dict, state=None):
    """The reference's jitted step from ``state`` (default: a fresh state
    of ``pair.ref_params``) -> (state as numpy, metrics as floats)."""
    step = jax.jit(ref_make_step(pair.ref_cfg, RefMode("train", "dense"),
                                 lr_kwargs=LR))
    state = ref_init_state(pair.ref_params) if state is None else state
    st, m = step(state, {k: jnp.asarray(v) for k, v in inputs.items()})
    return jax.tree.map(np.asarray, st), {k: float(v) for k, v in m.items()}


def port_step(pair, inputs: dict, state=None):
    """The port's step from ``state`` (default: a fresh state of a copy of
    ``pair.model``) -> (the port's state, metrics as floats)."""
    state = (init_train_state(copy.deepcopy(pair.model)) if state is None
             else state)
    st, m = make_train_step(pair.cfg, Mode("train", "dense"),
                            lr_kwargs=LR)(
        state, {k: torch.as_tensor(v) for k, v in inputs.items()})
    return st, {k: float(v) for k, v in m.items()}
