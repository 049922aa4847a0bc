"""Traffic-learned bucket shapes: fit the (n, d, batch) table to load
(port of ``repro/serve/cluster/traffic.py``, pure Python and the same fit).

A hand-written bucket table encodes a guess about traffic; the padding
waste of a wrong guess is quadratic (a request solves at its bucket's
n², not its own). This module closes the loop: mine observed request
shapes out of a benchmark record or loadgen trace, then fit the bucket
edges that minimize expected padded compute under a bucket-count budget.

``ClusterService.from_trace(...)`` is the front door::

    svc = ClusterService.from_trace("BENCH_serve.json")
    svc.warmup()

The fitter is deliberately simple and exact: group shapes by feature
dim, enumerate candidate edges (the distinct request sizes, rounded up
to power-of-two, as the reference does), and greedily add the edge with the
largest padded-compute saving until the budget is spent. Greedy is
optimal enough here because savings are monotone and the candidate set
is tiny (distinct sizes in a trace, not the integers).
"""
from __future__ import annotations

import json
import os
from collections import Counter
from typing import Iterable, Mapping, Union

from repro_torch.serve.cluster.buckets import MIN_BUCKET_N, _next_pow2

#: hard floor/ceiling on a fitted per-bucket micro-batch
MIN_FIT_BATCH = 1
MAX_FIT_BATCH = 64


def mine_trace(source) -> Counter:
    """Extract ``{(n, d): count}`` request-shape counts from a trace.

    Accepts, in order of preference:

    * a path to (or parsed dict of) ``BENCH_serve.json`` — rows carry
      ``shape_counts`` (written by either package's ``loadgen``;
      ``benchmarks/records/serve_scaleout_full.json`` is one);
    * a loadgen-style mapping ``{(n, d) | "n x d" | "n,d": count}``;
    * an iterable of ``(n, d)`` or ``(n, d, count)`` shape tuples.

    Unrecognizable rows are skipped, not fatal: a trace mined from a
    benchmark file that predates shape logging simply yields fewer
    shapes, and ``fit_buckets`` raises if nothing usable remains.
    """
    if isinstance(source, (str, os.PathLike)):
        with open(source) as fh:
            source = json.load(fh)
    counts: Counter = Counter()
    if isinstance(source, Mapping):
        if "rows" in source:            # BENCH_serve.json record
            for row in source.get("rows", []):
                _merge_shape_counts(counts, row.get("shape_counts", {}))
            return counts
        _merge_shape_counts(counts, source)
        return counts
    for item in source:                 # iterable of shape tuples
        try:
            n, d, *rest = item
            counts[(int(n), int(d))] += int(rest[0]) if rest else 1
        except (TypeError, ValueError):
            continue
    return counts


def _merge_shape_counts(counts: Counter, mapping: Mapping) -> None:
    for key, cnt in mapping.items():
        shape = _parse_shape_key(key)
        if shape is not None:
            counts[shape] += int(cnt)


def _parse_shape_key(key) -> Union[tuple, None]:
    """(n, d) tuple, "128x2", or "128,2" -> (n, d); else None."""
    if isinstance(key, (tuple, list)) and len(key) == 2:
        return int(key[0]), int(key[1])
    if isinstance(key, str):
        for sep in ("x", ","):
            if sep in key:
                a, _, b = key.partition(sep)
                try:
                    return int(a.strip()), int(b.strip())
                except ValueError:
                    return None
    return None


def fit_buckets(shapes, *, max_buckets: int = 4, max_batch: int = 8,
                total_rate: float = 0.0) -> list:
    """Fit ``(n, d, batch)`` bucket specs to observed traffic.

    ``shapes``: ``{(n, d): count}`` (or anything ``mine_trace`` accepts).
    ``max_buckets``: table-size budget across all feature dims (each
    fitted bucket is one more warmed handle — times the ladder — per
    worker, so the budget is a warm-up and memory knob).
    ``max_batch``: cap on any fitted micro-batch capacity.

    Edges: per feature dim, candidates are the distinct pow2-rounded
    request sizes; every dim gets its largest edge (all its traffic must
    route *somewhere*), then remaining budget goes greedily to the split
    with the biggest padded-compute saving, Σ count · edge(n)², across
    all dims. Batches: proportional to each bucket's traffic share,
    rounded to power-of-two in [1, max_batch] — hot buckets gather, cold
    buckets launch near-solo (a big batch on a cold bucket only adds
    compiled variants and gather latency).
    """
    counts = shapes if isinstance(shapes, Counter) else mine_trace(shapes)
    counts = Counter({k: v for k, v in counts.items() if v > 0})
    if not counts:
        raise ValueError("no usable (n, d) shapes in trace; cannot fit "
                         "buckets (pass buckets= explicitly)")
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1 (got {max_buckets})")

    by_dim: dict[int, Counter] = {}
    for (n, d), c in counts.items():
        by_dim.setdefault(int(d), Counter())[int(n)] += c
    if len(by_dim) > max_buckets:
        raise ValueError(
            f"trace holds {len(by_dim)} feature dims but max_buckets="
            f"{max_buckets}; every dim needs at least one bucket")

    # mandatory edge per dim: the largest (pow2-rounded) size
    edges: dict[int, set] = {
        d: {_next_pow2(max(sizes), MIN_BUCKET_N)}
        for d, sizes in by_dim.items()
    }
    budget = max_buckets - len(by_dim)

    def padded_cost(d: int, edge_set) -> float:
        ordered = sorted(edge_set)
        cost = 0.0
        for size, cnt in by_dim[d].items():
            edge = next(e for e in ordered
                        if _next_pow2(size, MIN_BUCKET_N) <= e)
            cost += cnt * float(edge) ** 2
        return cost

    while budget > 0:
        best = None                     # (saving, d, candidate_edge)
        for d, sizes in by_dim.items():
            base = padded_cost(d, edges[d])
            cands = ({_next_pow2(s, MIN_BUCKET_N) for s in sizes}
                     - edges[d])
            for e in cands:
                saving = base - padded_cost(d, edges[d] | {e})
                if saving > 0 and (best is None or saving > best[0]):
                    best = (saving, d, e)
        if best is None:                # no split saves anything
            break
        edges[best[1]].add(best[2])
        budget -= 1

    # batch per bucket ~ traffic share (pow2, clamped)
    total = sum(counts.values())
    out = []
    for d, edge_set in sorted(edges.items()):
        ordered = sorted(edge_set)
        for e in ordered:
            share = sum(
                cnt for size, cnt in by_dim[d].items()
                if _next_pow2(size, MIN_BUCKET_N) <= e
                and not any(e2 < e and _next_pow2(size, MIN_BUCKET_N) <= e2
                            for e2 in ordered)) / total
            batch = max(MIN_FIT_BATCH,
                        min(int(max_batch), MAX_FIT_BATCH,
                            _pow2_at_most(round(share * max_batch * 2))))
            out.append((int(e), int(d), int(batch)))
    return sorted(out)


def _pow2_at_most(v: int) -> int:
    if v <= 1:
        return 1
    return 1 << (v.bit_length() - 1)
