"""Shape buckets: the fixed-shape contract between requests and the
batched solve handles (port of ``repro/serve/cluster/buckets.py``).

The reference pays one XLA compilation per distinct (batch, n, d) shape;
the port pays none, but each shape is still one handle to warm and keep,
and a request solves at its bucket's n^2. The router quantizes: a small,
fixed set of (n, d) buckets, each with a fixed micro-batch capacity. A
request pads up to the smallest bucket that fits (zero rows past
``n_real`` for points — the batched solve masks them into inert dummies;
zero *columns* pad the feature dim, which leaves every pairwise distance,
and hence the clustering, unchanged).

Warm the buckets once and the steady state runs exactly as many handles
as there are (bucket, config) pairs, whatever the request mix.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

#: smallest auto-created bucket edge; tiny requests share one bucket
MIN_BUCKET_N = 64


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One padded shape class: requests with n <= ``n`` and d <= ``d``
    ride together, ``batch`` at a time."""
    n: int
    d: int
    batch: int = 8

    @property
    def key(self) -> tuple:
        return (self.n, self.d, self.batch)


def _next_pow2(v: int, floor: int = MIN_BUCKET_N) -> int:
    v = max(int(v), floor)
    return 1 << (v - 1).bit_length()


def batch_ladder(batch: int) -> tuple:
    """Power-of-two rider-count variants up to ``batch``: 1, 2, 4, …,
    ``batch``. A fixed-shape batch handle costs its full batch of
    compute whatever the real rider count (filler slots are solved too),
    so the scheduler launches the smallest warmed variant that fits the
    riders it actually gathered — the ladder is what it picks from."""
    out, v = [], 1
    while v < batch:
        out.append(v)
        v <<= 1
    out.append(int(batch))
    return tuple(out)


def ladder_fit(batch: int, riders: int) -> int:
    """Smallest ladder variant holding ``riders`` (<= ``batch``)."""
    for v in batch_ladder(batch):
        if v >= riders:
            return v
    return int(batch)


class BucketRouter:
    """Route (n, d) requests to buckets; optionally grow the table.

    ``buckets`` seeds the table — tuples ``(n, d)`` or ``(n, d, batch)``.
    With ``auto=True`` (default) an unroutable request creates a new
    bucket at the next power-of-two n (a new handle, surfaced in the
    compile-cache miss counter); with ``auto=False`` it raises, which is
    the configuration a latency-SLO deployment wants.
    """

    def __init__(self, buckets: Iterable = (), *, auto: bool = True,
                 default_batch: int = 8):
        self.auto = auto
        self.default_batch = int(default_batch)
        self._buckets: list[Bucket] = []
        for spec in buckets:
            if isinstance(spec, Bucket):
                self.add(spec)
            else:
                n, d, *rest = spec
                self.add(Bucket(int(n), int(d),
                                int(rest[0]) if rest else default_batch))

    @property
    def buckets(self) -> Sequence[Bucket]:
        return tuple(self._buckets)

    def add(self, bucket: Bucket) -> Bucket:
        if bucket.n < 2 or bucket.d < 1 or bucket.batch < 1:
            raise ValueError(f"degenerate bucket {bucket}")
        if bucket not in self._buckets:
            self._buckets.append(bucket)
            self._buckets.sort()
        return bucket

    def route(self, n: int, d: int, *,
              max_grow_n: Optional[int] = None) -> Optional[Bucket]:
        """Smallest-n bucket fitting (n, d); grows the table when allowed.

        Explicitly registered buckets always route, whatever their size.
        ``max_grow_n`` caps only *auto growth*: when the next power-of-two
        edge would exceed it, no bucket is minted and None is returned
        (the service's overflow path takes over). Returns None when
        nothing fits and growth is off or capped out."""
        fits = [b for b in self._buckets if n <= b.n and d <= b.d]
        if fits:
            # smallest padded area -> least wasted compute
            return min(fits, key=lambda b: (b.n, b.d))
        if not self.auto:
            return None
        grown = _next_pow2(n)
        if max_grow_n is not None and grown > max_grow_n:
            return None
        return self.add(Bucket(grown, d, self.default_batch))

    # ------------------------------------------------------------ padding
    @staticmethod
    def pad_points(points: np.ndarray, bucket: Bucket) -> np.ndarray:
        """(n, d) -> (bucket.n, bucket.d), zero rows/cols past the data."""
        n, d = points.shape
        out = np.zeros((bucket.n, bucket.d), np.float32)
        out[:n, :d] = points
        return out
