"""Clustering-service driver (port of ``repro/launch/cluster_serve.py``) —
stand up a warmed ``ClusterService`` and push a synthetic request load
through it, on a CUDA card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.cluster_serve \
        --buckets 128x2,512x2 --requests 200 --rps 20

    PYTHONPATH=src python -m repro_torch.launch.cluster_serve \
        --workers 2 --sources 4 --deadline-ms 500 --max-queue 16

    PYTHONPATH=src python -m repro_torch.launch.cluster_serve --smoke

    PYTHONPATH=src python -m repro_torch.launch.cluster_serve \
        --from-trace benchmarks/records/serve_scaleout_full.json

    PYTHONPATH=src python -m repro_torch.launch.cluster_serve --smoke \
        --device cpu                          # plain PyTorch on the CPU

Reports compile-cache behaviour (every handle built in warmup, none on
the request path — per worker), end-to-end latency percentiles,
throughput, shed/deadline counts under overload, and — with
``--stream-frac`` — the incremental fast-path share. ``--json`` writes
the record ``benchmarks/bench_serve.py`` emits, the offered shapes
included, so ``--from-trace`` can read it back. Without a card and
without ``--device cpu`` the driver exits with an error.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.serve.cluster import ClusterService
from repro_torch.serve.cluster.loadgen import run_load, synthetic_requests
from repro_torch.solver.config import SolveConfig


def parse_buckets(spec: str) -> list[tuple[int, int]]:
    """"128x2,512x2" -> [(128, 2), (512, 2)]."""
    out = []
    for part in spec.split(","):
        n, d = part.lower().split("x")
        out.append((int(n), int(d)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--buckets", default="128x2,512x2",
                    help="comma list of NxD shape buckets")
    ap.add_argument("--batch", type=int, default=8,
                    help="micro-batch capacity per bucket")
    ap.add_argument("--from-trace", default=None, metavar="PATH",
                    help="fit the bucket table from a BENCH_serve.json "
                         "trace instead of --buckets/--batch")
    ap.add_argument("--workers", type=int, default=1,
                    help="dispatch workers (queue shard + compile cache "
                         "+ scheduler thread each)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="per-worker queue bound; full everywhere = shed "
                         "(default: unbounded)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request SLO deadline; drives early batch "
                         "closing and expired-work drops")
    ap.add_argument("--sources", type=int, default=1,
                    help="concurrent Poisson submitter threads offering "
                         "the load")
    ap.add_argument("--no-ladder", action="store_true",
                    help="disable batch-ladder right-sizing (compile "
                         "only each bucket's full batch)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="gather-window cap per batch")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--rps", type=float, default=20.0,
                    help="offered load, requests/second (Poisson)")
    ap.add_argument("--stream-frac", type=float, default=0.0,
                    help="fraction of requests riding the incremental "
                         "fast path of one logical stream")
    ap.add_argument("--max-iterations", type=int, default=100)
    ap.add_argument("--damping", type=float, default=0.6)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes: CI-speed end-to-end check")
    ap.add_argument("--json", default=None,
                    help="also write a BENCH_serve-style json here")
    ap.add_argument("--device", default="cuda",
                    help="where the service solves: 'cuda' (round-robin "
                         "over the cards), 'cuda:N', or 'cpu'")
    args = ap.parse_args(argv)

    if args.smoke:
        args.buckets, args.batch = "64x2,128x2", 4
        args.requests, args.rps = 24, 10.0
        args.max_iterations = 60

    cfg = SolveConfig(stop="converged", max_iterations=args.max_iterations,
                      damping=args.damping, levels=args.levels,
                      preference="median", seed=args.seed,
                      device=args.device)
    service_kw = dict(workers=args.workers, max_queue=args.max_queue,
                      batch_ladder=not args.no_ladder,
                      max_wait_ms=args.max_wait_ms)
    if args.from_trace:
        svc = ClusterService.from_trace(args.from_trace, config=cfg,
                                        **service_kw)
        shapes = [(b.n, b.d) for b in svc.router.buckets]
        print(f"[cluster_serve] trace-fitted buckets: "
              f"{[b.key for b in svc.router.buckets]}")
    else:
        shapes = parse_buckets(args.buckets)
        svc = ClusterService(
            config=cfg, buckets=[(n, d, args.batch) for n, d in shapes],
            **service_kw)
    delta = svc.warmup()
    print(f"[cluster_serve] warmup: {len(svc.router.buckets)} buckets x "
          f"{args.workers} workers, {delta['misses']} compiles in "
          f"{delta['compile_seconds']:.2f}s")

    reqs = synthetic_requests(args.requests, shapes, seed=args.seed)
    res = run_load(svc, reqs, rps=args.rps,
                   stream="cli" if args.stream_frac > 0 else None,
                   stream_frac=args.stream_frac, seed=args.seed,
                   sources=args.sources, deadline_ms=args.deadline_ms)
    snap = svc.snapshot()
    print(f"[cluster_serve] {res.n_requests} requests @ "
          f"{res.offered_rps:.1f} rps offered ({res.sources} sources) -> "
          f"{res.achieved_rps:.1f} rps achieved | "
          f"p50 {res.p50_ms:.1f} ms  p99 {res.p99_ms:.1f} ms | "
          f"{res.n_errors} errors ({res.n_shed} shed, "
          f"{res.n_deadline} deadline)")
    print(f"[cluster_serve] micro-batches={snap['micro_batches']} "
          f"fast-path={snap['fast_assigns']} "
          f"stolen={snap['stolen_batches']} "
          f"cache hits/misses={snap['cache']['hits']}/"
          f"{snap['cache']['misses']}")
    for w in snap["workers"]:
        print(f"[cluster_serve]   worker {w['worker']}: "
              f"{w['compiled']} handles, "
              f"hits/misses={w['cache']['hits']}/{w['cache']['misses']}, "
              f"queued={w['queued']}")
    post_warm = snap["cache"]["misses"] - delta["misses"]
    if post_warm:
        print(f"[cluster_serve] WARNING: {post_warm} request-path "
              "compiles (bucket table did not cover the load)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"bench": "serve",
                       "rows": [res.row(f"serve_load_{args.rps:g}")],
                       "meta": {"smoke": args.smoke,
                                "workers": args.workers,
                                **snap["cache"]}},
                      f, indent=1, default=float)
        print(f"[cluster_serve] wrote {args.json}")
    # shed/deadline errors under an explicit bound are the service working
    # as configured, not a failure of the driver run
    hard_errors = res.n_errors - res.n_shed - res.n_deadline
    return 1 if (hard_errors or post_warm) else 0


if __name__ == "__main__":
    raise SystemExit(main())
