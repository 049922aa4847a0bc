"""``ClusterService`` — clustering as a long-lived request engine (port
of ``repro/serve/cluster/service.py``).

The solver engine (``repro_torch.solver.solve``) is script-shaped: every
caller runs alone. This front door turns it into a service:

* ``submit(points, ...) -> Future`` — requests enter a queue and resolve
  to a ``ClusterResponse``;
* a shape-bucket micro-batcher: requests padded to a small set of (n, d)
  buckets, compatible requests batched through one batched dense solve
  (``repro_torch.solver.compiled``), launched at the smallest warmed
  power-of-two *batch variant* that fits the gathered riders
  (``batch_ladder`` — a fixed-shape handle costs its full batch of
  compute whatever the rider count). ``dense_fused`` maps to the parallel
  order there, as in the reference, so this path launches none of the
  hand-written kernels: it is plain batched PyTorch;
* a **multi-worker dispatch layer** (``dispatch.py``): ``workers`` queue
  shards, each with its own ``CompileCache`` pinned to the worker's
  device and its own scheduler thread, least-loaded admission, and work
  stealing so one hot shard never strands idle capacity;
* **SLO-aware scheduling**: ``submit(deadline_ms=...)`` sets a deadline
  per request; batch closing is deadline-driven, work whose deadline
  already passed is dropped with ``DeadlineExceededError``, and bounded
  queues (``max_queue``) shed excess load with explicit
  ``ServiceOverloadedError`` rejections (``stats.sheds``);
* an explicit handle cache per worker with hit/miss counters and a
  ``warmup()`` API, so the steady state makes no handle on the request
  path, and *provably* so;
* an incremental fast path per logical stream: once a stream has a full
  solve, new points are assigned to its exemplar set in O(n * K) on the
  host (``incremental.py``), and a drift threshold triggers a background
  full re-solve;
* big-N overflow routing, per worker: a request larger than every bucket
  the service will build (``max_bucket_n``) runs as one direct
  ``dense_topk`` solve with a capped neighbor count (``overflow_k``) —
  on the card that launches the fused top-k kernel (``csrc/topk_build.cu``)
  once — and past ``overflow_coarsen_n`` it escapes to the two-level
  ``coarsen`` backend.

Devices: the service runs where its config says — ``device="cpu"`` keeps
every worker on the CPU; otherwise the workers go round-robin over the
host's CUDA cards, and without a card the constructor raises (nothing
falls back to the CPU). Each worker's launches run inside
``torch.cuda.device(worker.device)``: the kernels launch through
``ctypes`` onto the calling thread's current device.

Pumping is explicit or threaded: call ``drain()`` to process every
worker's queue on the caller's thread (deterministic — what the tests
use), or ``start()`` one scheduler thread per worker that gathers batches
under the SLO rules above.

``ClusterService.from_trace(...)`` builds the bucket table from observed
traffic (a ``BENCH_serve.json`` record or a shape list) instead of hand
configuration — see ``traffic.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from repro_torch.runtime import faultinject
from repro_torch.serve.cluster.buckets import Bucket, BucketRouter, ladder_fit
from repro_torch.serve.cluster.compile_cache import CompileCache
from repro_torch.serve.cluster.dispatch import (
    ClusterRequest, DeadlineExceededError, ServiceOverloadedError,
    WorkerFailedError, WorkerShard, close_at, pop_batch, steal_batch,
)
from repro_torch.serve.cluster.incremental import AssignResult, StreamState
from repro_torch.solver.compiled import slice_request
from repro_torch.solver.config import SolveConfig
from repro_torch.solver.engine import finalize_raw, validate_config
from repro_torch.solver.result import SolveResult


@dataclasses.dataclass
class ClusterResponse:
    """What a request's future resolves to.

    ``path`` is "full" (micro-batched solve; ``solve`` holds the engine's
    uniform SolveResult) or "assign" (incremental fast path; ``assign``
    holds labels against the stream's exemplar set). ``labels`` is the
    finest-level cluster id per point on either path.
    """
    path: str                          # "full" | "assign"
    labels: np.ndarray                 # (n,) int32
    solve: Optional[SolveResult] = None
    assign: Optional[AssignResult] = None
    bucket: Optional[tuple] = None     # (n, d, batch) the request rode in
    stream: Optional[str] = None
    generation: Optional[int] = None   # stream solve generation consumed
    worker: Optional[int] = None       # dispatch worker that ran the solve
    queue_ms: float = 0.0
    solve_ms: float = 0.0


@dataclasses.dataclass
class ServiceStats:
    requests: int = 0
    full_solves: int = 0
    fast_assigns: int = 0
    micro_batches: int = 0
    batched_requests: int = 0          # full solves that shared a batch
    resolves_triggered: int = 0
    overflow_solves: int = 0           # big-N requests routed around buckets
    overflow_coarsen_solves: int = 0   # of those, past the dense_topk
                                       # ceiling -> coarsen backend
    sheds: int = 0                     # admission control rejections
    deadline_rejects: int = 0          # deadline already expired at submit
    deadline_drops: int = 0            # deadline expired while queued
    stolen_batches: int = 0            # batches run by a non-owning worker
    worker_deaths: int = 0             # launch failures that marked a
                                       # worker unhealthy (pump deaths too)
    retried_batches: int = 0           # failed batches re-admitted to a
                                       # surviving worker
    requeued_requests: int = 0         # queued requests moved off a dead
                                       # worker's shard
    resurrections: int = 0             # unhealthy workers brought back
                                       # with a fresh compile cache
    cache: dict = dataclasses.field(default_factory=dict)

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


#: ceiling on the per-attempt retry backoff — exponential growth must
#: never hold a pump thread longer than this per failed batch
RETRY_BACKOFF_CAP_S = 0.1


class ClusterService:
    """Shape-bucketed, compile-cached, multi-worker clustering engine."""

    def __init__(self, *, config: Optional[SolveConfig] = None,
                 buckets=(), auto_bucket: bool = True, max_batch: int = 8,
                 max_wait_ms: float = 2.0, drift_threshold: float = 0.25,
                 drift_halflife: int = 256,
                 stream_max_points: int = 100_000,
                 max_bucket_n: int = 4096, overflow: str = "route",
                 overflow_k: int = 64,
                 overflow_coarsen_n: Optional[int] = 200_000,
                 workers: int = 1, max_queue: Optional[int] = None,
                 batch_ladder: bool = True, max_retries: int = 2,
                 worker_cooldown_s: float = 5.0,
                 retry_backoff_ms: float = 5.0):
        cfg = config or SolveConfig(stop="converged", max_iterations=100)
        # fail at construction, not mid-traffic: the batched dense path
        # ignores sparse-topk k, so a config carrying it is a mistake
        if cfg.k is not None:
            raise ValueError(
                "SolveConfig.k is a dense_topk knob; the service's "
                "micro-batched path runs dense solves and would silently "
                "ignore it — leave k=None (route big-N work to solve())")
        validate_config(cfg, n=2**30)
        if overflow not in ("route", "reject"):
            raise ValueError(f"overflow must be 'route' or 'reject'; "
                             f"got {overflow!r}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1 (got {workers})")
        self.config = cfg
        self.router = BucketRouter(buckets, auto=auto_bucket,
                                   default_batch=max_batch)
        self.stats = ServiceStats()
        self.max_wait_ms = float(max_wait_ms)
        # big-N overflow: requests past the largest bucket the service
        # will compile go to a direct dense_topk solve (capped k, O(n*k)
        # state) instead of being rejected or growing an unbounded
        # micro-batch handle
        self.max_bucket_n = int(max_bucket_n)
        self.overflow = overflow
        self.overflow_k = int(overflow_k)
        # past the dense_topk comfort ceiling even the O(n*k) edge list
        # and its n-column build strain one request's latency/memory
        # budget; such requests escape to the two-level coarsen backend
        # (None disables the escape hatch)
        self.overflow_coarsen_n = (None if overflow_coarsen_n is None
                                   else int(overflow_coarsen_n))
        self.batch_ladder = bool(batch_ladder)
        # failure recovery: a launch failure marks its worker unhealthy;
        # its riders retry on survivors (capped exponential backoff, up
        # to max_retries attempts), its queue redistributes, and after
        # worker_cooldown_s the worker resurrects with a fresh warmed
        # compile cache. Every future still resolves — the worst case is
        # WorkerFailedError, never a hang.
        self.max_retries = int(max_retries)
        self.worker_cooldown_s = float(worker_cooldown_s)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self._drift_threshold = drift_threshold
        self._drift_halflife = drift_halflife
        self._stream_max_points = stream_max_points
        self._started = False

        self._lock = threading.Lock()
        self._streams: dict[str, StreamState] = {}
        self._rr = 0                    # dispatch tie-break rotation
        devices = _worker_devices(int(workers), cfg.device)
        # one solve at a time on each device: an eager solve is hundreds
        # of small ops, each issued under the GIL, and workers that
        # interleave them on one device stall one another at every host
        # read (PERF.md §5: on an NVIDIA H100 80GB HBM3 at 700 W, four
        # workers on one card served 10-13 rps where one served 35);
        # whole solves in turn keep the card busy
        self._device_locks = {d: threading.Lock() for d in set(devices)}
        self.workers = [WorkerShard(i, device=devices[i],
                                    max_queue=max_queue)
                        for i in range(int(workers))]

    # --------------------------------------------------------- from_trace
    @classmethod
    def from_trace(cls, trace, *, config: Optional[SolveConfig] = None,
                   max_buckets: int = 4, max_batch: int = 8,
                   **service_kw) -> "ClusterService":
        """Build the bucket table from observed traffic instead of hand
        configuration: ``trace`` is a ``BENCH_serve.json`` record (path
        or parsed dict — its rows carry per-shape request counts), a
        loadgen shape-count dict, or a plain iterable of ``(n, d)`` /
        ``(n, d, count)`` shapes. The fitter (``traffic.fit_buckets``)
        picks the (n, d, batch) set minimizing expected padded compute.
        Traffic-fitted deployments default to a *fixed* table
        (``auto_bucket=False``) — the SLO posture; pass
        ``auto_bucket=True`` to allow growth anyway."""
        from repro_torch.serve.cluster.traffic import fit_buckets, mine_trace

        shapes = mine_trace(trace)
        fitted = fit_buckets(shapes, max_buckets=max_buckets,
                             max_batch=max_batch)
        service_kw.setdefault("auto_bucket", False)
        return cls(config=config, buckets=fitted, **service_kw)

    # ---------------------------------------------------------- properties
    @property
    def cache(self):
        """Worker 0's compile cache (single-worker compatibility handle;
        multi-worker introspection goes through ``snapshot()``)."""
        return self.workers[0].cache

    @property
    def running(self) -> bool:
        return any(w.running for w in self.workers)

    @property
    def max_wait_s(self) -> float:
        return self.max_wait_ms / 1e3

    # ------------------------------------------------------------ warmup
    def warmup(self, shapes=None) -> dict:
        """Build every (bucket, service-config) handle up front —
        on every worker's cache, including the power-of-two batch-variant
        ladder when ``batch_ladder`` is on.

        ``shapes``: extra ``(n, d)`` / ``(n, d, batch)`` specs to register
        before building (the expected traffic envelope). Returns the
        compile-cache delta summed over workers — ``misses`` is the
        number of handles built here instead of on the request path.
        Warmup always uses the service's own config: that is the key
        every request hits.
        """
        for spec in shapes or ():
            n, d, *rest = spec
            self.router.add(Bucket(int(n), int(d),
                                   int(rest[0]) if rest
                                   else self.router.default_batch))
        total = {"hits": 0, "misses": 0, "compile_seconds": 0.0}
        for w in self.workers:
            delta = w.cache.warm(self.router.buckets, self.config,
                                 ladder=self.batch_ladder)
            for k in total:
                total[k] += delta[k]
        return total

    # ------------------------------------------------------------ submit
    def submit(self, points, *, stream: Optional[str] = None,
               mode: str = "auto",
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue a clustering request; returns a Future[ClusterResponse].

        ``mode``: "auto" rides the incremental fast path whenever the
        stream already has an exemplar set, "full" forces a micro-batched
        solve, "assign" demands the fast path (errors if the stream has
        no exemplars yet).

        ``deadline_ms``: SLO budget relative to now. The scheduler closes
        a gathering batch early rather than breach it; a request whose
        deadline passes while queued fails with ``DeadlineExceededError``
        (a deadline that is already non-positive fails immediately —
        counted in ``stats.deadline_rejects``).
        """
        if mode not in ("auto", "full", "assign"):
            raise ValueError(f"unknown mode {mode!r}")
        if stream is not None and self.config.metric != "neg_sqeuclidean":
            # the fast path's nearest-exemplar matmul and its drift test
            # (best_sim vs preference) are negative-squared-Euclidean
            # quantities; under another metric they would silently
            # disagree with the full solves
            raise ValueError(
                "streams (incremental assignment) require "
                f"metric='neg_sqeuclidean'; this service is configured "
                f"with metric={self.config.metric!r} — submit without "
                "stream= for plain micro-batched solves")
        pts = np.asarray(points, np.float32)
        if pts.ndim != 2:
            raise ValueError(f"points must be (n, d); got {pts.shape}")
        fut: Future = Future()
        now = time.perf_counter()
        if deadline_ms is not None and deadline_ms <= 0:
            # expired before it was ever queued: reject at the door so the
            # caller's error budget sees it in microseconds, not after a
            # pointless queue round-trip
            with self._lock:
                self.stats.requests += 1
                self.stats.deadline_rejects += 1
            fut.set_exception(DeadlineExceededError(
                f"deadline_ms={deadline_ms} already expired at submit"))
            return fut
        deadline = (None if deadline_ms is None
                    else now + float(deadline_ms) / 1e3)
        with self._lock:
            self.stats.requests += 1
            st = self._stream_state(stream) if stream else None

        if st is not None and mode != "full":
            with st.lock:
                if st.ready:
                    self._fast_assign(st, pts, fut, now)
                    return fut
                if mode == "assign":
                    fut.set_exception(RuntimeError(
                        f"stream {stream!r} has no exemplar set yet; "
                        "submit a full solve first"))
                    return fut
        elif mode == "assign":
            fut.set_exception(RuntimeError(
                "mode='assign' needs a stream with a prior full solve"))
            return fut

        if pts.shape[0] < 2:
            # degenerate single-point request: trivially its own exemplar
            fut.set_result(self._trivial_response(pts, stream))
            return fut
        self._enqueue(ClusterRequest(pts, pts.shape[0], fut, stream, now,
                                     deadline=deadline))
        return fut

    def solve_sync(self, points, **kw) -> ClusterResponse:
        """submit + drain + result — the one-caller convenience path."""
        fut = self.submit(points, **kw)
        if not fut.done():
            self.drain()
        return fut.result()

    # ------------------------------------------------------- fast path
    def _fast_assign(self, st: StreamState, pts, fut: Future,
                     submitted: float) -> None:
        """Incremental assignment under the stream lock; sets the future
        inline (O(n*K) matmul — cheaper than any queue round-trip)."""
        t0 = time.perf_counter()
        res = st.assign(pts)
        st.absorb(pts)
        gen = st.generation
        trigger = res.resolve_triggered
        dt = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.stats.fast_assigns += 1
            if trigger:
                self.stats.resolves_triggered += 1
        fut.set_result(ClusterResponse(
            path="assign", labels=res.labels, assign=res,
            stream=st.stream_id, generation=gen,
            queue_ms=(t0 - submitted) * 1e3, solve_ms=dt))
        if trigger:
            # background full re-solve over the stream's accumulated
            # buffer; its future is internal (result lands in the
            # stream). The working set is capped at the largest bucket so
            # a re-solve can never force a new shape (and a request-path
            # compile) — the most recent points win.
            window = max((b.n for b in self.router.buckets),
                         default=self._stream_max_points)
            # re-calibrate the drift yardstick to the window the re-solve
            # will see (st.lock is held by submit): while the solve is in
            # flight, and for any batch the EWMA judges after it,
            # staleness is measured against the data's *current* scale,
            # not the last solve's
            st.recalibrate(self.config.preference, window)
            buf = st.points[-window:].copy()
            self._enqueue(ClusterRequest(buf, len(buf), Future(),
                                         st.stream_id,
                                         time.perf_counter(),
                                         internal=True))

    def _trivial_response(self, pts, stream) -> ClusterResponse:
        n = pts.shape[0]
        labels = np.zeros((n,), np.int32)
        return ClusterResponse(path="full", labels=labels, stream=stream)

    # ---------------------------------------------------------- queueing
    def _stream_state(self, stream: str) -> StreamState:
        st = self._streams.get(stream)
        if st is None:
            st = self._streams[stream] = StreamState(
                stream, drift_threshold=self._drift_threshold,
                drift_halflife=self._drift_halflife,
                max_points=self._stream_max_points)
        return st

    def _enqueue(self, req: ClusterRequest) -> None:
        # explicitly provisioned buckets always win (whatever their
        # size); max_bucket_n caps only auto-growth, so overflow takes
        # whatever no warmed handle covers. The router mutates its
        # table under auto-growth — serialize it.
        with self._lock:
            bucket = self.router.route(req.n, req.points.shape[1],
                                       max_grow_n=self.max_bucket_n)
        if bucket is None:
            # bucket overflow: n is past every compiled shape and past
            # what auto-growth may mint. Route to a direct sparse
            # dense_topk solve instead of rejecting — O(n * k) state,
            # no new compile-cache entry.
            if self.overflow == "route":
                self._dispatch(req, None)
                return
            req.future.set_exception(ValueError(
                f"no bucket fits request shape {req.points.shape} "
                f"(max_bucket_n={self.max_bucket_n}) and overflow "
                "routing is off; add a bucket via warmup(shapes=...) or "
                "construct the service with overflow='route'"))
            return
        self._dispatch(req, bucket.key)

    def _dispatch(self, req: ClusterRequest, key: Optional[tuple]) -> None:
        """Least-loaded *healthy* worker admission with round-robin
        tie-break; internal re-solves bypass the bound (no caller is
        waiting on them, and they are capped at one in flight per
        stream). When every shard is full the request is shed — an
        explicit, immediate rejection instead of unbounded queue growth.
        With every worker unhealthy, resurrection is attempted inline
        (cooldown-gated first, then forced — better a resurrect compile
        than a guaranteed failure); only if none can come back does the
        request fail with ``WorkerFailedError``."""
        if self._started and not any(
                w.thread is not None and w.thread.is_alive()
                for w in self.workers):
            # started service whose pump threads have all died: queueing
            # would hang the caller forever — fail fast instead
            self._fail_request(req, WorkerFailedError(
                "service pump threads have died; call start() again "
                "after fixing the fault (see stats.worker_deaths)"))
            return
        with self._lock:
            rr = self._rr = (self._rr + 1) % len(self.workers)
        healthy = [w for w in self.workers if w.healthy]
        if not healthy:
            for w in self.workers:
                if self._maybe_resurrect(w):
                    break
            healthy = [w for w in self.workers if w.healthy]
        if not healthy and self._force_resurrect() is not None:
            healthy = [w for w in self.workers if w.healthy]
        if not healthy:
            self._fail_request(req, WorkerFailedError(
                f"all {len(self.workers)} workers are unhealthy and "
                "none could be resurrected"))
            return
        order = sorted(healthy,
                       key=lambda w: (w.depth(),
                                      (w.wid - rr) % len(self.workers)))
        if req.internal:
            order[0].try_admit(req, key, force=True)
            return
        for w in order:
            if w.try_admit(req, key):
                return
        with self._lock:
            self.stats.sheds += 1
        req.future.set_exception(ServiceOverloadedError(
            f"all {len(self.workers)} worker queues full "
            f"(max_queue={self.workers[0].max_queue}); request shed"))

    # ------------------------------------------------------- recovery
    def _fail_request(self, r: ClusterRequest, exc: BaseException) -> None:
        """Terminal failure for one request: release the stream's
        resolve_pending flag when an internal re-solve dies (or the
        stream could never schedule another), then resolve the future."""
        if r.internal and r.stream is not None:
            with self._lock:
                st = self._streams.get(r.stream)
            if st is not None:
                with st.lock:
                    st.resolve_pending = False
        if not r.future.done():
            r.future.set_exception(exc)

    def _maybe_resurrect(self, w: WorkerShard) -> bool:
        """True when ``w`` is (or just became) healthy. Resurrection is
        cooldown-gated: a worker that just died gets ``worker_cooldown_s``
        of quiet before the service pays a fresh warm-up compile for it."""
        if w.healthy:
            return True
        with w.work:
            failed_at = w.failed_at
        if (failed_at is not None
                and time.perf_counter() - failed_at < self.worker_cooldown_s):
            return False
        return self._resurrect(w)

    def _force_resurrect(self) -> Optional[WorkerShard]:
        """Cooldown-ignoring resurrection sweep — the no-healthy-worker
        escape hatch (a compile beats a guaranteed WorkerFailedError)."""
        for w in self.workers:
            if not w.healthy and self._resurrect(w):
                return w
        return None

    def _resurrect(self, w: WorkerShard) -> bool:
        """Bring an unhealthy worker back with a *fresh* compile cache,
        fully warmed before it takes traffic (whatever poisoned the old
        cache — a wedged handle, a monkeypatched one, a device in
        a bad state — is discarded wholesale). A warm-up failure leaves
        the worker unhealthy and restarts its cooldown."""
        cache = CompileCache(device=w.device)
        try:
            cache.warm(self.router.buckets, self.config,
                       ladder=self.batch_ladder)
        except Exception:
            with w.work:
                w.failed_at = time.perf_counter()
            return False
        with w.work:
            w.cache = cache
            w.healthy = True
            w.failed_at = None
            w.work.notify_all()
        with self._lock:
            self.stats.resurrections += 1
        return True

    def _redistribute(self, dead: WorkerShard) -> int:
        """Drain a dead worker's shard onto the least-loaded healthy
        survivor (force-admitted: these requests already passed admission
        once). With no survivor, fail each — never strand a future on a
        queue nothing will pump."""
        moved = 0
        while True:
            grabbed = pop_batch(dead)
            if grabbed is None:
                break
            bucket, reqs = grabbed
            key = None if bucket is None else bucket.key
            survivors = [s for s in self.workers
                         if s.healthy and s is not dead]
            target = (min(survivors, key=lambda s: s.depth())
                      if survivors else None)
            for r in reqs:
                if target is None:
                    self._fail_request(r, WorkerFailedError(
                        f"worker {dead.wid} died and no healthy worker "
                        "remains to take its queue"))
                else:
                    target.try_admit(r, key, force=True)
                    moved += 1
        if moved:
            with self._lock:
                self.stats.requeued_requests += moved
        return moved

    def _on_worker_failure(self, w: WorkerShard, bucket: Optional[Bucket],
                           live, exc: BaseException) -> None:
        """A launch on ``w`` raised: mark it unhealthy, move its queue to
        survivors, and retry the failed riders with capped exponential
        backoff — bounded by each rider's deadline and ``max_retries``.
        Every rider's future resolves down one of these paths."""
        first = False
        with w.work:
            if w.healthy:
                w.healthy = False
                first = True
            w.failed_at = time.perf_counter()
        if first:
            with self._lock:
                self.stats.worker_deaths += 1
        self._redistribute(w)
        retry, delay = [], 0.0
        now = time.perf_counter()
        backoff_s = self.retry_backoff_ms / 1e3
        for r in live:
            r.attempts += 1
            survivors = [s for s in self.workers if s.healthy]
            if r.attempts > self.max_retries or not survivors:
                self._fail_request(r, WorkerFailedError(
                    f"worker {w.wid} failed after {r.attempts} "
                    f"attempt(s): {exc!r}"))
                continue
            d = min(backoff_s * (2 ** (r.attempts - 1)),
                    RETRY_BACKOFF_CAP_S)
            if r.deadline is not None and now + d > r.deadline:
                # the retry itself would breach the SLO — deadline
                # semantics win over retry semantics
                self._drop_expired(r)
                continue
            retry.append(r)
            delay = max(delay, d)
        if not retry:
            return
        time.sleep(delay)
        survivors = [s for s in self.workers if s.healthy]
        if not survivors:
            for r in retry:
                self._fail_request(r, WorkerFailedError(
                    f"worker {w.wid} failed and no healthy worker "
                    "remains to retry on"))
            return
        with self._lock:
            self.stats.retried_batches += 1
        target = min(survivors, key=lambda s: s.depth())
        key = None if bucket is None else bucket.key
        for r in retry:
            target.try_admit(r, key, force=True)

    def _pump_died(self, w: WorkerShard, exc: BaseException) -> None:
        """Watchdog: a scheduler thread died outside the per-batch guard.
        Mark the worker down, move its queue; when no other live pump
        remains, fail every pending future — a started service must never
        leave callers blocked on futures nothing will resolve."""
        with w.work:
            w.healthy = False
            w.running = False
            w.failed_at = time.perf_counter()
        with self._lock:
            self.stats.worker_deaths += 1
        others = [o for o in self.workers
                  if o is not w and o.running and o.thread is not None
                  and o.thread.is_alive()]
        try:
            self._redistribute(w)
        except BaseException:  # noqa: BLE001 — the queue layer itself died
            others = []
        if not others:
            self._fail_all_pending(WorkerFailedError(
                f"service pump died: {exc!r}"))

    def _fail_all_pending(self, exc: BaseException) -> None:
        """Sweep every shard's queues directly (no pop/dispatch helpers —
        this path must survive a broken queue layer) and fail each
        request. The terminal guarantee: no future outlives its pumps."""
        for w in self.workers:
            with w.work:
                reqs = [r for q in w.queues.values() for r in q]
                reqs.extend(w.overflow)
                w.queues.clear()
                w.overflow.clear()
                w.queued = 0
            for r in reqs:
                self._fail_request(r, exc)

    # ----------------------------------------------------------- pumping
    def drain(self) -> int:
        """Process queued micro-batches on the caller's thread until
        every worker's queue is empty (drift re-solves enqueued mid-drain
        included). Returns the number of batches executed.

        Unhealthy workers are not pumped: their queues redistribute to
        survivors (or the worker resurrects first, cooldown permitting).
        An exception escaping the drain itself — recovery is exercised
        *inside* ``_run_batch`` — fails every pending future before
        re-raising, so a crashed pump never strands a caller."""
        batches = 0
        try:
            while True:
                progressed = False
                for w in self.workers:
                    if not w.healthy:
                        if not self._maybe_resurrect(w):
                            progressed |= self._redistribute(w) > 0
                            continue
                    grabbed = pop_batch(w)
                    if grabbed is not None:
                        self._run_batch(w, *grabbed)
                        batches += 1
                        progressed = True
                if not progressed:
                    return batches
        except BaseException as exc:
            self._fail_all_pending(WorkerFailedError(
                f"drain() died mid-pump: {exc!r}"))
            raise

    def drain_worker(self, wid: int) -> int:
        """Pump a single worker on the caller's thread — its own shard
        first, then stealing from peers until nothing is reachable.
        Deterministic work-stealing surface (tests, benchmarks)."""
        w = self.workers[wid]
        batches = 0
        while True:
            grabbed = pop_batch(w)
            if grabbed is None:
                grabbed = steal_batch(w, self.workers)
                if grabbed is None:
                    return batches
                with self._lock:
                    self.stats.stolen_batches += 1
            self._run_batch(w, *grabbed)
            batches += 1

    def start(self) -> None:
        """Background scheduling: one gather/solve thread per worker,
        closing batches under the SLO rules (deadline slack or the
        ``max_wait_ms`` cap, whichever is tighter)."""
        self._started = True
        for w in self.workers:
            with w.work:
                if w.running:
                    continue
                w.running = True
            w.thread = threading.Thread(
                target=self._worker_main, args=(w,),
                name=f"cluster-serve-{w.wid}", daemon=True)
            w.thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._started = False
        for w in self.workers:
            with w.work:
                w.running = False
                w.work.notify_all()
        for w in self.workers:
            if w.thread is not None:
                w.thread.join(timeout)
                w.thread = None

    def _worker_main(self, w: WorkerShard) -> None:
        """Thread entry: the loop body already survives per-batch solver
        failures (``_run_batch`` routes them through recovery); this
        outer guard is the watchdog for everything else — a bug in the
        scheduler itself must fail pending futures, not strand them."""
        try:
            self._worker_loop(w)
        except BaseException as exc:  # noqa: BLE001 — watchdog by design
            self._pump_died(w, exc)

    def _worker_loop(self, w: WorkerShard) -> None:
        while True:
            if not w.healthy:
                # down worker: hand the queue to survivors, then sit out
                # the cooldown before resurrecting with a fresh cache
                self._redistribute(w)
                with w.work:
                    if not w.running:
                        return
                if not self._maybe_resurrect(w):
                    time.sleep(0.02)
                    continue
            now = time.perf_counter()
            with w.work:
                t = close_at(w, now, self.max_wait_s)
                if t is None and not w.running:
                    return
                if t is not None and t > now:
                    # gather: sleep to the close instant, but wake on new
                    # arrivals (they can only tighten the close time) and
                    # re-evaluate
                    w.work.wait(min(t - now, 0.05))
                    continue
            if t is None:
                # idle: try to steal from a deeper peer, then nap briefly
                grabbed = steal_batch(w, self.workers)
                if grabbed is None:
                    with w.work:
                        if close_at(w, time.perf_counter(),
                                    self.max_wait_s) is None:
                            w.work.wait(0.02)
                    continue
                with self._lock:
                    self.stats.stolen_batches += 1
            else:
                grabbed = pop_batch(w)
                if grabbed is None:       # raced with a thief
                    continue
            self._run_batch(w, *grabbed)

    # ------------------------------------------------------ micro-batch
    def _drop_expired(self, req: ClusterRequest) -> None:
        with self._lock:
            self.stats.deadline_drops += 1
        if not req.future.done():
            req.future.set_exception(DeadlineExceededError(
                "deadline expired while queued (the service is past "
                "this request's SLO; see stats.deadline_drops)"))

    def _solver_for(self, w: WorkerShard, bucket: Bucket, riders: int):
        """The smallest warmed batch variant that fits ``riders`` — a
        right-sized launch costs the variant's compute, not the full
        bucket's. Falls back to the bucket's own batch (compiling if it
        must — only reachable for auto-grown, never-warmed buckets)."""
        if self.batch_ladder:
            vb = Bucket(bucket.n, bucket.d,
                        ladder_fit(bucket.batch, riders))
            solver = w.cache.lookup(vb, self.config)
            if solver is not None:
                return solver, vb
        return w.cache.get(bucket, self.config), bucket

    def _run_batch(self, w: WorkerShard, bucket: Optional[Bucket],
                   reqs) -> None:
        """Pad, run one right-sized batched solve, finish each rider.
        ``bucket=None`` is an overflow request: one direct sparse solve.
        Either runs with the worker's card as the thread's current device,
        whichever thread pumps the worker (its scheduler, ``drain()``, or
        a thief's)."""
        with _device_scope(w.device):
            if bucket is None:
                self._run_overflow(w, reqs[0])
            else:
                self._run_bucket(w, bucket, reqs)

    def _run_bucket(self, w: WorkerShard, bucket: Bucket, reqs) -> None:
        now = time.perf_counter()
        live = []
        for r in reqs:
            if r.expired(now) and not r.internal:
                self._drop_expired(r)
            else:
                live.append(r)
        if not live:
            return
        t0 = time.perf_counter()
        try:
            faultinject.fire("serve.launch", worker=w.wid,
                             bucket=bucket.key)
            solver, vb = self._solver_for(w, bucket, len(live))
            pts = np.zeros((vb.batch, bucket.n, bucket.d), np.float32)
            n_real = np.full((vb.batch,), 2, np.int32)  # inert filler
            for i, r in enumerate(live):
                pts[i] = self.router.pad_points(r.points, bucket)
                n_real[i] = r.n
            with self._device_locks[w.device]:
                raw = solver.run(pts, n_real)
        except Exception as exc:  # one bad batch must not wedge the queue
            # a launch failure is a *worker* failure: mark the shard
            # down, move its queue, retry the riders on survivors (each
            # future still resolves — result, deadline, or
            # WorkerFailedError after max_retries)
            self._on_worker_failure(w, bucket, live, exc)
            return
        dt_s = time.perf_counter() - t0
        w.note_launch(bucket.key, dt_s)
        dt = dt_s * 1e3
        with self._lock:
            self.stats.micro_batches += 1
            self.stats.full_solves += len(live)
            self.stats.batched_requests += max(len(live) - 1, 0)
        for i, r in enumerate(live):
            rbr, pref = slice_request(raw, i, r.n, self.config.stop)
            result = finalize_raw(rbr, r.n, "serve_batched")
            gen = None
            if r.stream is not None:
                gen = self._install_stream(r, result, pref)
            if not r.future.done():
                r.future.set_result(ClusterResponse(
                    path="full", labels=result.labels[0], solve=result,
                    bucket=bucket.key, stream=r.stream, generation=gen,
                    worker=w.wid,
                    queue_ms=(t0 - r.submitted) * 1e3, solve_ms=dt))

    # -------------------------------------------------------- overflow
    def _overflow_preference(self, pts: np.ndarray,
                             device: Optional[torch.device] = None
                             ) -> float:
        """The preference the routed dense_topk solve effectively uses,
        for stream drift detection — replicating ``build_from_points``'s
        own branches: the stored-top-k statistic up to ``PREF_EXACT_N``,
        with the top-k values from the port's build dispatch (the fused
        kernel on the card), and the sampled estimate with the port's
        seeded generator past it (ROADMAP C3: not the reference's draw);
        numeric strategies are themselves."""
        strategy = self.config.preference
        if strategy is None:
            return 0.0
        if not isinstance(strategy, str):
            return float(np.min(np.asarray(strategy)))
        if strategy in ("median", "range_mid"):
            from repro_torch.solver.topk import (
                PREF_EXACT_N, sample_generator, sampled_preferences,
                topk_preferences,
            )
            from repro_torch.solver.topk_build import build_topk_similarity

            x = torch.from_numpy(np.asarray(pts, np.float32)).to(
                device or "cpu")
            n = x.shape[0]
            k = min(self.overflow_k, n - 1)
            if n > PREF_EXACT_N and k < n - 1:
                return float(sampled_preferences(
                    x, strategy, self.config.metric,
                    sample_generator(self.config.seed))[0])
            vals, _ = build_topk_similarity(x, k, self.config)
            return float(topk_preferences(vals, strategy)[0])
        return 0.0

    def _run_overflow(self, w: WorkerShard, req: ClusterRequest) -> None:
        """Big-N request -> one dense_topk solve with a capped neighbor
        count; past ``overflow_coarsen_n`` (and with a partition-
        compatible preference), one two-level coarsen solve instead —
        same response/stream contract as the batched path either way."""
        from repro_torch.solver import solve
        from repro_torch.solver.config import coarsen_pref_ok

        if req.expired() and not req.internal:
            self._drop_expired(req)
            return
        t0 = time.perf_counter()
        use_coarsen = (self.overflow_coarsen_n is not None
                       and req.n > self.overflow_coarsen_n
                       and coarsen_pref_ok(self.config.preference))
        try:
            device = None if w.device is None else str(w.device)
            if use_coarsen:
                cfg = self.config.replace(
                    backend="coarsen", input_kind="points", device=device)
            else:
                cfg = self.config.replace(
                    backend="dense_topk",
                    k=min(self.overflow_k, req.n - 1),
                    input_kind="points", device=device)
            with self._device_locks[w.device]:
                result = solve(req.points, cfg)
        except Exception as exc:
            # overflow failures are *content* failures (one request, the
            # real solver, its real error) — fail the rider, keep the
            # worker: retrying the same bad input on a survivor would
            # just fail twice
            self._fail_request(req, exc)
            return
        dt = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.stats.overflow_solves += 1
            if use_coarsen:
                self.stats.overflow_coarsen_solves += 1
            self.stats.full_solves += 1
        gen = None
        if req.stream is not None:
            with self._device_locks[w.device]:
                pref = self._overflow_preference(req.points, w.device)
            gen = self._install_stream(req, result, pref)
        if not req.future.done():
            req.future.set_result(ClusterResponse(
                path="full", labels=result.labels[0], solve=result,
                bucket=None, stream=req.stream, generation=gen,
                worker=w.wid,
                queue_ms=(t0 - req.submitted) * 1e3, solve_ms=dt))

    def _install_stream(self, r: ClusterRequest, result: SolveResult,
                        pref: float) -> int:
        """A stream-tagged full solve installs its finest-level exemplar
        set (coordinates) as the stream's assignment target."""
        with self._lock:
            st = self._stream_state(r.stream)
        with st.lock:
            ex_idx = np.unique(result.exemplars[0])
            st.install(r.points[ex_idx], pref)
            if not r.internal:
                st.absorb(r.points)
            return st.generation

    # ------------------------------------------------------------- intro
    def stream_info(self, stream: str) -> dict:
        with self._lock:
            st = self._streams.get(stream)
        if st is None:
            return {}
        with st.lock:
            return {
                "ready": st.ready, "generation": st.generation,
                "n_exemplars": (0 if st.exemplar_points is None
                                else len(st.exemplar_points)),
                "drift": st.drift_ewma, "preference": st.preference,
                "buffered_points": 0 if st.points is None
                                   else len(st.points),
                "resolve_pending": st.resolve_pending,
            }

    def snapshot(self) -> dict:
        """One consistent stats view: the counter dict is a single copy
        taken under the service lock (the drain/scheduler threads mutate
        counters concurrently — field-by-field reads would tear), then
        per-worker cache/queue gauges, each copied under its own lock."""
        with self._lock:
            s = self.stats.snapshot()
            buckets = [b.key for b in self.router.buckets]
        agg = {"hits": 0, "misses": 0, "compile_seconds": 0.0}
        per_worker, compiled = [], 0
        for w in self.workers:
            c = w.cache.snapshot()
            per_worker.append({"worker": w.wid, "queued": w.depth(),
                               "healthy": w.healthy,
                               "compiled": len(w.cache), "cache": c})
            for k in agg:
                agg[k] += c[k]
            compiled += len(w.cache)
        s["cache"] = agg
        s["workers"] = per_worker
        s["buckets"] = buckets
        s["compiled"] = compiled
        return s


def _device_scope(device: Optional[torch.device]):
    """Make ``device`` the calling thread's current CUDA device (the
    kernels launch onto it through ``ctypes``); a no-op off CUDA."""
    if device is not None and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


_NO_CUDA = ("CUDA is not available; construct the service with "
            "SolveConfig(device='cpu') to serve on the CPU")


def _worker_devices(n_workers: int, device=None) -> list:
    """Device per worker. ``device`` (``SolveConfig.device``) names one
    when the caller set it — "cpu", or a card such as "cuda:1" — and every
    worker takes it. Otherwise, and for a bare "cuda", the workers go
    round-robin over ``cuda:0 … cuda:{count-1}``, each worker's cache
    building on its own card; with no card that raises: nothing falls
    back to the CPU. The count is torch's, one host's cards (ROADMAP C4)."""
    dev = torch.device(device or "cuda")
    if dev.type != "cuda":
        return [dev] * n_workers
    if not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    if dev.index is not None:
        return [dev] * n_workers
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n_workers)]
