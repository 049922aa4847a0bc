"""Explicit cache of the solver's batched handles (port of
``repro/serve/cluster/compile_cache.py``).

The reference XLA-compiles one executable per miss. Eager PyTorch has
nothing to compile, yet the cache keeps the reference's contract: the
handles are made and ``compile()``d here and nowhere else, so "the
request path built a handle" is a counted event, and the hit, miss and
``compile_seconds`` counters are what the service's "zero misses after
warmup" checks read.

Each dispatch worker owns one of these; ``device`` pins the worker's
handles (a CUDA card, or the CPU), and the cache key carries that device,
so a key never names a handle on another device. ``warm`` builds the full
power-of-two *batch ladder* per bucket — variants at rider counts 1, 2,
4, …, ``bucket.batch`` — so the scheduler can launch a handle sized to
the riders it actually gathered.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional

from repro_torch.runtime import faultinject
from repro_torch.serve.cluster.buckets import Bucket, batch_ladder
from repro_torch.solver.compiled import BatchedDenseSolver, config_static_key
from repro_torch.solver.config import SolveConfig


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    compile_seconds: float = 0.0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class CompileCache:
    """(bucket, config) -> compiled BatchedDenseSolver, with counters."""

    def __init__(self, device: Any = None):
        self.device = device
        self._lock = threading.Lock()
        self._cache: dict[tuple, BatchedDenseSolver] = {}
        self.stats = CacheStats()

    def _pinned(self, cfg: SolveConfig) -> SolveConfig:
        """``cfg`` on this cache's device: the device the handle runs on
        is the one its key names."""
        return cfg if self.device is None else cfg.replace(
            device=str(self.device))

    def key(self, bucket: Bucket, cfg: SolveConfig) -> tuple:
        return (bucket.key, config_static_key(self._pinned(cfg)))

    def get(self, bucket: Bucket, cfg: SolveConfig) -> BatchedDenseSolver:
        """The only point in the serving stack that makes a handle."""
        key = self.key(bucket, cfg)
        with self._lock:
            solver = self._cache.get(key)
            if solver is not None:
                self.stats.hits += 1
                return solver
            # build inside the lock: concurrent first requests for one
            # bucket must not both pay (and double-count) the miss
            faultinject.fire("serve.compile", bucket=bucket.key)
            self.stats.misses += 1
            t0 = time.perf_counter()
            solver = BatchedDenseSolver(
                bucket.batch, bucket.n, bucket.d, self._pinned(cfg),
                device=self.device).compile()
            self.stats.compile_seconds += time.perf_counter() - t0
            self._cache[key] = solver
            return solver

    def lookup(self, bucket: Bucket, cfg: SolveConfig
               ) -> Optional[BatchedDenseSolver]:
        """A hit or None — never builds (the scheduler uses this to
        right-size a launch without risking a request-path miss)."""
        with self._lock:
            solver = self._cache.get(self.key(bucket, cfg))
            if solver is not None:
                self.stats.hits += 1
            return solver

    def warm(self, buckets, cfg: SolveConfig, *,
             ladder: bool = False) -> dict:
        """Build every (bucket, cfg) handle — with ``ladder=True`` every
        power-of-two batch variant per bucket too, so right-sized
        launches stay miss-free. Returns the stats delta."""
        before = self.snapshot()
        for b in buckets:
            variants = (batch_ladder(b.batch) if ladder else (b.batch,))
            for v in variants:
                self.get(Bucket(b.n, b.d, v), cfg)
        after = self.snapshot()
        return {k: after[k] - before[k] for k in before}

    def snapshot(self) -> dict:
        """Counter snapshot under the cache lock — one consistent copy
        (the drain/scheduler threads mutate these concurrently)."""
        with self._lock:
            return self.stats.snapshot()

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)
