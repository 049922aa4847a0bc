"""Multi-worker dispatch: queue shards, SLO deadlines, work stealing
(port of ``repro/serve/cluster/dispatch.py``, pure Python and numpy).

This module is the dispatch substrate ``ClusterService`` schedules over:

* ``WorkerShard`` — one per worker: its *own* ``CompileCache`` (pinned
  to the worker's device: a CUDA card, or the CPU), its own bucket-queue
  shard and overflow queue, its own scheduler thread, and a per-bucket
  EWMA of recent launch times that the SLO gather logic consults;
* ``ClusterRequest`` — the queued unit, now carrying an absolute
  ``deadline`` (from ``submit(deadline_ms=...)``). Deadlines drive batch
  closing (a batch closes when waiting longer would breach the earliest
  rider's deadline) and let the service drop work that already missed its
  SLO instead of burning capacity on it;
* admission control — ``max_queue`` bounds each worker's queue; when
  every worker is full the request is *shed* with an explicit
  ``ServiceOverloadedError`` (counted in ``stats.sheds``) so overload
  shows up as fast rejections, not unbounded latency;
* work stealing — an idle worker pops the oldest batch from the deepest
  peer's shard, so one hot queue never strands capacity elsewhere.

Locking discipline: each shard has exactly one lock; stealing locks only
the victim's shard (never two shards at once), so there is no lock
ordering to get wrong.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Optional

import numpy as np

from repro_torch.serve.cluster.buckets import Bucket
from repro_torch.serve.cluster.compile_cache import CompileCache


class DeadlineExceededError(RuntimeError):
    """The request's SLO deadline passed before (or while) it was served."""


class ServiceOverloadedError(RuntimeError):
    """Admission control shed the request: every worker queue is full."""


class WorkerFailedError(RuntimeError):
    """The request exhausted its retries against failing workers (or no
    healthy worker remained to retry on). Every future the service hands
    out resolves — with this, a deadline error, or a result — so callers
    never hang on a dead worker."""


@dataclasses.dataclass
class ClusterRequest:
    """One queued clustering request (the unit every queue holds).

    ``deadline`` is an absolute ``time.perf_counter()`` instant (None =
    no SLO): the scheduler closes a gathering batch early rather than
    breach it, and drops the request with ``DeadlineExceededError`` if it
    expires while still queued. ``internal`` marks drift-triggered
    re-solves — they have no caller waiting, bypass admission control,
    and never carry deadlines. ``attempts`` counts launch attempts that
    died under this request (worker failures) — the retry policy caps it
    at ``ClusterService.max_retries`` before failing the future with
    ``WorkerFailedError``.
    """
    points: np.ndarray
    n: int
    future: Future
    stream: Optional[str]
    submitted: float
    deadline: Optional[float] = None
    internal: bool = False
    attempts: int = 0

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.perf_counter() if now is None else now) > self.deadline


#: gather-window estimate for a bucket that has never launched (seconds)
DEFAULT_EST_S = 0.05
#: EWMA weight of the newest launch observation
EST_ALPHA = 0.3


class WorkerShard:
    """One worker's scheduling state: queues + compile cache + clock.

    The service owns the policy (what to pop, when to close a batch);
    the shard owns the data and its single lock. ``device`` pins this
    worker's handles and tensors (a ``torch.device``; None leaves the
    handles on ``cfg.device`` or "cuda"), and the service runs the
    worker's launches inside ``torch.cuda.device(device)``.
    """

    def __init__(self, wid: int, *, device: Any = None,
                 max_queue: Optional[int] = None):
        self.wid = int(wid)
        self.device = device
        self.max_queue = None if max_queue is None else int(max_queue)
        self.cache = CompileCache(device=device)
        self.lock = threading.Lock()
        self.work = threading.Condition(self.lock)
        self.queues: "OrderedDict[tuple, deque[ClusterRequest]]" = (
            OrderedDict())
        self.overflow: "deque[ClusterRequest]" = deque()
        self.overflow_turn = True
        self.queued = 0                 # all requests currently queued here
        self._est_s: dict[tuple, float] = {}   # bucket key -> launch EWMA
        self.thread: Optional[threading.Thread] = None
        self.running = False
        # failure-recovery state: a launch failure marks the shard
        # unhealthy; the service stops routing to it, redistributes its
        # queue, and resurrects it (fresh compile cache) after a cooldown
        self.healthy = True
        self.failed_at: Optional[float] = None

    # ------------------------------------------------------------ enqueue
    def try_admit(self, req: ClusterRequest, key: Optional[tuple], *,
                  force: bool = False) -> bool:
        """Append ``req`` to the bucket queue ``key`` (None = overflow).
        Returns False when the shard is full and ``force`` is not set —
        the caller tries the next worker or sheds."""
        with self.work:
            if (not force and self.max_queue is not None
                    and self.queued >= self.max_queue):
                return False
            if key is None:
                self.overflow.append(req)
            else:
                self.queues.setdefault(key, deque()).append(req)
            self.queued += 1
            self.work.notify()
            return True

    # ------------------------------------------------------------- timing
    def est_s(self, key: tuple) -> float:
        """Expected launch wall time for this bucket (EWMA, seconds)."""
        return self._est_s.get(key, DEFAULT_EST_S)

    def note_launch(self, key: tuple, seconds: float) -> None:
        prev = self._est_s.get(key)
        self._est_s[key] = (seconds if prev is None
                            else (1 - EST_ALPHA) * prev
                            + EST_ALPHA * seconds)

    def depth(self) -> int:
        """Approximate queue depth — read without the lock, for the
        dispatcher's least-loaded choice (admission re-checks exactly)."""
        return self.queued


def close_at(shard: WorkerShard, now: float, max_wait_s: float
             ) -> Optional[float]:
    """When should this shard close (launch) its next batch?

    Caller holds ``shard.lock``. Returns None when the shard holds no
    work; ``now`` (close immediately) when any bucket queue already holds
    a full batch or overflow work is waiting (overflow rides alone —
    gathering buys it nothing); otherwise the earliest of, over every
    queued request:

    * ``submitted + max_wait_s`` — the gather cap: nobody waits longer
      than the configured window just to fill a batch;
    * ``deadline - est(bucket)`` — the SLO horizon: launch early enough
      that the expected solve still lands inside the rider's deadline.

    This is the deadline-driven replacement for the fixed gather window:
    an SLO-tight rider collapses the window, slack traffic fills batches.
    """
    if shard.overflow:
        return now
    best: Optional[float] = None
    for key, q in shard.queues.items():
        if not q:
            continue
        if len(q) >= key[2]:            # key = (n, d, batch)
            return now
        est = shard.est_s(key)
        for r in q:
            t = r.submitted + max_wait_s
            if r.deadline is not None:
                t = min(t, r.deadline - est)
            best = t if best is None else min(best, t)
    return best


def pop_batch(shard: WorkerShard) -> Optional[tuple]:
    """Pop up to ``batch`` requests from the shard's oldest non-empty
    bucket queue, or one overflow request — FIFO across buckets, overflow
    alternating with bucketed work (strict priority either way would let
    one traffic class starve the other). Returns ``(bucket | None,
    requests)`` or None. Caller must NOT hold the shard lock."""
    with shard.work:
        if shard.overflow and (shard.overflow_turn or not shard.queues):
            shard.overflow_turn = False
            shard.queued -= 1
            return None, [shard.overflow.popleft()]
        shard.overflow_turn = True
        for key in list(shard.queues):
            q = shard.queues[key]
            if not q:
                del shard.queues[key]
                continue
            bucket = Bucket(*key)
            reqs = [q.popleft() for _ in range(min(len(q), bucket.batch))]
            shard.queued -= len(reqs)
            if not q:
                del shard.queues[key]
            return bucket, reqs
        if shard.overflow:
            # bucket queues turned out empty — don't strand overflow
            shard.overflow_turn = False
            shard.queued -= 1
            return None, [shard.overflow.popleft()]
        return None


def steal_batch(thief: WorkerShard, shards: list[WorkerShard]
                ) -> Optional[tuple]:
    """An idle worker pops one batch from the deepest non-empty peer.

    Victims are scanned deepest-first but *every* non-empty peer is
    visited before giving up, so a non-empty queue can never be starved
    by repeated unlucky victim choices. Only the victim's lock is taken.
    """
    victims = sorted((s for s in shards if s.wid != thief.wid),
                     key=lambda s: -s.depth())
    for v in victims:
        if v.depth() <= 0:
            continue
        grabbed = pop_batch(v)
        if grabbed is not None:
            return grabbed
    return None
