"""The cost of a torch program, counted from the ops it dispatches (port
of ``repro/launch/hlo_cost.py`` by what it reports, not how).

There is no HLO here. The reference compiles a step and walks XLA's
optimized module, multiplying each while body by its trip count; the port
runs the program under ``CostCounter``, a ``TorchDispatchMode`` that sees
every aten op torch dispatches, forward and backward alike. On the
``meta`` device nothing is computed and nothing is allocated, so a
full-size model costs only the dispatch.

  flops : the product FLOPs, by ``torch.utils.flop_counter``'s formulas
          (mm, addmm, bmm, baddbmm, convolutions, attention);
  bytes : per op, the bytes of its tensor operands and results, views and
          allocations excluded. Eager PyTorch materialises every op's
          output, so this is the program's memory traffic op by op; XLA's
          fusion would keep part of it on chip;
  elementwise : the output elements of the other ops (the reference counts
          them about as one flop each and then leaves them out);
  wire  : the bytes the program's collectives send (``sharding.dist``'s
          ``Traffic``), by kind.

Every figure is one rank's: the program is one rank's.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

#: ops that move no data: allocations whose contents are undefined, and
#: metadata
_NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided,
             aten.new_empty, aten.new_empty_strided, aten.detach,
             aten.lift_fresh, aten.set_}


class Cost(NamedTuple):
    flops: float
    bytes: float
    elementwise: float
    wire_bytes: float
    wire_by_type: dict
    collective_ops: int


def _leaves(x, out: list) -> list:
    """The leaves of an op's arguments or results (tuples, lists, dicts)."""
    if isinstance(x, (list, tuple)):
        for y in x:
            _leaves(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _leaves(y, out)
    else:
        out.append(x)
    return out


def _meta_key(x):
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    return x if isinstance(x, (int, float, bool, str, type(None),
                               torch.dtype, torch.device)) else repr(x)


def _layout(out):
    """How to make fresh meta results like ``out``: a tensor, or a flat
    tuple or list of tensors and Nones; None for anything else."""
    def one(t):
        return None if t is None else (t.shape, t.stride(), t.dtype)
    if isinstance(out, torch.Tensor):
        return one(out)
    if isinstance(out, (tuple, list)) and all(
            t is None or isinstance(t, torch.Tensor) for t in out):
        return type(out), [one(t) for t in out]
    return None


def _fresh(layout):
    def one(m):
        return None if m is None else torch.empty_strided(
            m[0], m[1], dtype=m[2], device="meta")
    if isinstance(layout[0], type):
        return layout[0](one(m) for m in layout[1])
    return one(layout)


class CostCounter(TorchDispatchMode):
    """Counts what ``Cost`` reports over the ops dispatched inside it.

    On the ``meta`` device an op's results depend only on its operands'
    shapes, strides and dtypes and its other arguments; so an op seen
    before with the same ones gets fresh meta results of the same layout
    without running its meta kernel again (a model's layer and time loops
    repeat a few hundred signatures). Views, in-place ops and ops whose
    results alias an operand always run."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.elementwise = 0.0
        self._seen: dict = {}

    def _run(self, func, args, kwargs, leaves):
        if func.is_view or func._schema.is_mutable or not all(
                t.is_meta for t in leaves if isinstance(t, torch.Tensor)):
            return func(*args, **kwargs)
        key = (func, len(args), tuple(_meta_key(x) for x in leaves))
        layout = self._seen.get(key)
        if layout is not None:
            return _fresh(layout)
        out = func(*args, **kwargs)
        ids = {id(t) for t in leaves}
        outs = _leaves(out, [])
        if all(t.is_meta for t in outs if isinstance(t, torch.Tensor)) \
                and not any(id(t) in ids for t in outs):
            layout = _layout(out)
            if layout is not None:
                self._seen[key] = layout
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = _leaves(kwargs, _leaves(args, []))
        out = self._run(func, args, kwargs, leaves)
        packet = func._overloadpacket
        if func.is_view or packet in _NO_BYTES:
            return out
        # an in-place op's result is its operand: counted once
        ids = {id(t) for t in leaves}
        results = [t for t in _leaves(out, [])
                   if isinstance(t, torch.Tensor) and id(t) not in ids]
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        else:
            self.elementwise += sum(t.numel() for t in results)
        self.bytes += sum(t.numel() * t.element_size()
                          for t in leaves + results
                          if isinstance(t, torch.Tensor))
        return out


def analyze(fn: Callable, *args, traffic=None, **kwargs) -> tuple[Any, Cost]:
    """-> (``fn(*args, **kwargs)``, its ``Cost``); ``traffic`` is the
    ``dist.Traffic`` the program's collectives count into (a mesh's), whose
    growth over the call is the wire figure."""
    sent = dict(traffic.by_kind) if traffic is not None else {}
    ops0 = traffic.ops if traffic is not None else 0
    counter = CostCounter()
    with counter:
        out = fn(*args, **kwargs)
    by_type: dict = {}
    if traffic is not None:
        by_type = {k: v - sent.get(k, 0) for k, v in traffic.by_kind.items()
                   if v - sent.get(k, 0)}
    return out, Cost(counter.flops, counter.bytes, counter.elementwise,
                     float(sum(by_type.values())), by_type,
                     (traffic.ops - ops0) if traffic is not None else 0)


def _combine(costs: list, weights: list) -> Cost:
    """sum_i weights[i] * costs[i], field by field."""
    kinds = set().union(*(c.wire_by_type for c in costs))
    return Cost(
        *(sum(w * c[f] for c, w in zip(costs, weights)) for f in range(4)),
        {k: sum(w * c.wire_by_type.get(k, 0) for c, w in zip(costs, weights))
         for k in kinds},
        sum(w * c.collective_ops for c, w in zip(costs, weights)))


def polynomial_fit(costs: dict, at: float) -> Cost:
    """The cost at ``at`` of the polynomial through ``{x: Cost}`` (two
    points: a line; three: a parabola), field by field: how the dry run
    takes a cell from the depths and lengths it counts to the config's.
    Every unit of layers costs the same, so the cost is linear in units
    (the reference multiplies its scan body by the trip count); at a
    fixed attention layout it is a quadratic in the sequence length."""
    xs = sorted(costs)
    weights = []
    for i, xi in enumerate(xs):
        w = 1.0
        for j, xj in enumerate(xs):
            if j != i:
                w *= (at - xj) / (xi - xj)
        weights.append(w)
    return _combine([costs[x] for x in xs], weights)


def state_bytes(shardings: Any, shapes: Any) -> int:
    """The bytes of this rank's blocks of a tree of leaves (anything with
    ``shape`` and ``dtype``) under a matching tree of ``Sharding``s."""
    from repro_torch.models.layers.common import tree_map
    from repro_torch.sharding.partitioning import Sharding
    total = [0]

    def one(sh, leaf):
        n = 1
        for d in sh.block_shape(tuple(leaf.shape)):
            n *= d
        total[0] += n * torch.empty((), dtype=leaf.dtype).element_size()
    tree_map(one, shardings, shapes,
             is_leaf=lambda x: isinstance(x, Sharding))
    return total[0]
