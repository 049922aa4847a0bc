"""Synthetic load generation against a ``ClusterService`` (port of
``repro/serve/cluster/loadgen.py``; the requests and the Poisson gaps come
from the reference's numpy calls, so both packages offer the same load).

Used by the ``repro_torch.launch.cluster_serve`` driver and
``chip_smoke.py``'s serve phase: build a mixed request population over the
service's shape buckets, offer it at a Poisson arrival rate through the
background scheduler, and report end-to-end latency percentiles +
achieved throughput.

``sources=N`` offers the load from N concurrent submitter threads, each
an independent Poisson process at ``rps / N`` — the multi-process
offered-load shape a scaled deployment sees (many clients, one service),
which is what exercises the dispatch layer's admission and least-loaded
routing. The service is in-process, so "multi-process" here means
multiple concurrent arrival processes, not OS processes.

``deadline_ms`` attaches an SLO deadline to every offered request;
``LoadResult`` then splits errors into sheds (admission control) and
deadline misses, so an overload run shows *bounded* latency plus
explicit rejections instead of a blown-up p99. ``shape_counts`` records
the offered (n, d) mix — the trace ``ClusterService.from_trace`` mines.
Beyond the reference's fields, ``LoadResult`` carries ``p95_ms`` and
``first_ms`` (the first offered request's latency: whether the first
request after warmup pays anything the steady state does not).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import Counter
from typing import Optional, Sequence

import numpy as np

from repro_torch.data.synth import gaussian_blobs
from repro_torch.serve.cluster.dispatch import (
    DeadlineExceededError, ServiceOverloadedError,
)
from repro_torch.serve.cluster.service import ClusterService


@dataclasses.dataclass
class LoadResult:
    offered_rps: float
    achieved_rps: float
    p50_ms: float
    p99_ms: float
    mean_ms: float
    n_requests: int
    n_errors: int
    n_shed: int                # admission-control rejections
    n_deadline: int            # deadline rejects + in-queue drops
    fast_frac: float           # fraction served by incremental assignment
    duration_s: float
    sources: int = 1
    shape_counts: dict = dataclasses.field(default_factory=dict)
    p95_ms: float = float("nan")
    first_ms: float = float("nan")   # the first offered request's latency

    def row(self, name: str) -> dict:
        return {"name": name, **dataclasses.asdict(self)}


def synthetic_requests(n_requests: int, shapes: Sequence[tuple], *,
                       seed: int = 0, clusters: int = 4) -> list:
    """A deterministic mixed-shape request population: blobs data at each
    (n, d) shape, round-robin so every bucket sees steady traffic."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        n, d = shapes[i % len(shapes)]
        # jitter n below the bucket edge: real traffic is never bucket-sized
        n_eff = int(max(clusters * 2, n - rng.integers(0, max(n // 4, 1))))
        x, _ = gaussian_blobs(n=n_eff, k=clusters, dim=d,
                              seed=int(rng.integers(1 << 31)), spread=0.4)
        out.append(np.asarray(x, np.float32))
    return out


def _offer(svc: ClusterService, requests: list, *, rps: float,
           stream: Optional[str], stream_frac: float, seed: int,
           deadline_ms: Optional[float], records: list) -> None:
    """One submitter: a Poisson arrival process over its request slice."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rps, 1e-9), size=len(requests))
    arrival = time.perf_counter()
    for i, pts in enumerate(requests):
        arrival += gaps[i]
        now = time.perf_counter()
        if arrival > now:
            time.sleep(arrival - now)
        t_sub = time.perf_counter()
        use_stream = (stream is not None
                      and (i == 0 or rng.random() < stream_frac))
        rec = {"arrival": t_sub, "shape": tuple(pts.shape)}
        try:
            fut = svc.submit(pts, stream=stream if use_stream else None,
                             mode="auto", deadline_ms=deadline_ms)
        except Exception as exc:       # submit itself must never raise here
            rec.update(done=time.perf_counter(), path="error", error=exc)
            records.append(rec)
            continue
        records.append(rec)

        def _stamp(f, r=rec):
            exc = f.exception()
            r.update(done=time.perf_counter(),
                     path=(f.result().path if exc is None else "error"),
                     error=exc)

        fut.add_done_callback(_stamp)
        rec["future"] = fut


def run_load(svc: ClusterService, requests: list, *, rps: float,
             stream: Optional[str] = None, stream_frac: float = 0.0,
             seed: int = 0, timeout: float = 300.0, sources: int = 1,
             deadline_ms: Optional[float] = None) -> LoadResult:
    """Offer ``requests`` at total Poisson rate ``rps`` req/s from
    ``sources`` concurrent submitters; measure arrival-to-completion
    latency per request.

    ``stream_frac`` of requests (after the first, which seeds the
    stream's exemplar set) ride the incremental fast path when ``stream``
    is set. Latency includes queueing + padding + micro-batch solve;
    shed / deadline-missed requests count as errors, not latency samples.
    """
    sources = max(int(sources), 1)
    started = not svc.running
    if started:
        svc.start()
    per_source: list[list] = [[] for _ in range(sources)]
    t_begin = time.perf_counter()
    try:
        if sources == 1:
            _offer(svc, requests, rps=rps, stream=stream,
                   stream_frac=stream_frac, seed=seed,
                   deadline_ms=deadline_ms, records=per_source[0])
        else:
            threads = []
            for s in range(sources):
                slice_ = requests[s::sources]
                th = threading.Thread(
                    target=_offer, args=(svc, slice_),
                    kwargs=dict(rps=rps / sources, stream=stream,
                                stream_frac=stream_frac, seed=seed + s,
                                deadline_ms=deadline_ms,
                                records=per_source[s]),
                    name=f"loadgen-{s}", daemon=True)
                th.start()
                threads.append(th)
            for th in threads:
                th.join(timeout)
        records = [r for recs in per_source for r in recs]
        for rec in records:
            if "future" in rec:
                rec["future"].exception(timeout=timeout)
        # Future.set_result wakes waiters BEFORE running done-callbacks,
        # so the stamps may lag .exception() by a beat — join on them
        deadline = time.perf_counter() + 5.0
        for rec in records:
            while "done" not in rec and time.perf_counter() < deadline:
                time.sleep(1e-3)
    finally:
        if started:
            svc.stop()
    t_end = time.perf_counter()
    lat = np.array([(r["done"] - r["arrival"]) * 1e3 for r in records
                    if "done" in r and r["path"] != "error"])
    first = min(records, key=lambda r: r["arrival"], default=None)
    n_err = sum(1 for r in records if r.get("path") == "error")
    n_shed = sum(1 for r in records
                 if isinstance(r.get("error"), ServiceOverloadedError))
    n_dead = sum(1 for r in records
                 if isinstance(r.get("error"), DeadlineExceededError))
    fast = sum(1 for r in records if r.get("path") == "assign")
    shape_counts = Counter(f"{s[0]}x{s[1]}" for s in
                           (r["shape"] for r in records))
    dur = t_end - t_begin
    return LoadResult(
        offered_rps=float(rps),
        achieved_rps=len(lat) / dur if dur > 0 else 0.0,
        p50_ms=float(np.percentile(lat, 50)) if len(lat) else float("nan"),
        p99_ms=float(np.percentile(lat, 99)) if len(lat) else float("nan"),
        mean_ms=float(lat.mean()) if len(lat) else float("nan"),
        n_requests=len(records), n_errors=n_err,
        n_shed=n_shed, n_deadline=n_dead,
        fast_frac=fast / max(len(records), 1), duration_s=dur,
        sources=sources, shape_counts=dict(shape_counts),
        p95_ms=float(np.percentile(lat, 95)) if len(lat) else float("nan"),
        first_ms=((first["done"] - first["arrival"]) * 1e3
                  if first is not None and "done" in first
                  and first["path"] != "error" else float("nan")))
