"""Clustering-as-a-service over the port's solver engine (port of
``repro.serve.cluster``).

    from repro_torch.serve.cluster import ClusterService

    svc = ClusterService(buckets=[(128, 2), (512, 2)], workers=2)  # "cuda"
    svc.warmup()                                   # every handle built here
    fut = svc.submit(points, stream="sensors",     # Future[ClusterResponse]
                     deadline_ms=500)
    svc.drain()                                    # or svc.start() threads
    fut.result().labels

Pass ``config=SolveConfig(device="cpu", ...)`` to serve on the CPU;
without it the service needs a CUDA card. docs/serving.md describes the
reference's architecture, which this package follows module for module.
"""
from repro_torch.serve.cluster.buckets import (
    Bucket, BucketRouter, batch_ladder, ladder_fit,
)
from repro_torch.serve.cluster.compile_cache import CacheStats, CompileCache
from repro_torch.serve.cluster.dispatch import (
    ClusterRequest, DeadlineExceededError, ServiceOverloadedError,
    WorkerFailedError, WorkerShard,
)
from repro_torch.serve.cluster.incremental import AssignResult, StreamState
from repro_torch.serve.cluster.service import (
    ClusterResponse, ClusterService, ServiceStats,
)
from repro_torch.serve.cluster.traffic import fit_buckets, mine_trace

__all__ = [
    "Bucket", "BucketRouter", "batch_ladder", "ladder_fit",
    "CacheStats", "CompileCache",
    "ClusterRequest", "DeadlineExceededError", "ServiceOverloadedError",
    "WorkerFailedError", "WorkerShard",
    "AssignResult", "StreamState", "ClusterResponse", "ClusterService",
    "ServiceStats", "fit_buckets", "mine_trace",
]
