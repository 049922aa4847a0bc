"""Shared fixtures and helpers of the port's clustering-service tests
(``tests/test_torch_serve*.py``): the service configuration, the
module-scoped warm service, seeded blob requests, and the parity harness
that drives the JAX service and the port's on the same traffic.

Parity runs both services with ``drain()``, so no threads run. The port
builds S with PyTorch's arithmetic and the reference with XLA's, which
contracts multiply-adds (ROADMAP C2), so the strict parity tests feed
the port the reference's similarity values (``reference_similarity``):
from the same S, every decision, trace and counter must be equal. From
points, the decisions of converged solves must be equal too, and the
traces agree within C2's allowance.
"""
import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import pytest
import torch

from repro_torch.data import gaussian_blobs
from repro_torch.serve.cluster import ClusterService
from repro_torch.solver import SolveConfig

CFG = SolveConfig(stop="converged", max_iterations=80, damping=0.6,
                  levels=2, preference="median", device="cpu")
RECORD = (Path(__file__).resolve().parents[1] / "benchmarks" / "records"
          / "serve_scaleout_full.json")



@pytest.fixture(scope="module")
def service():
    svc = ClusterService(config=CFG, buckets=[(64, 2, 4), (128, 2, 4)],
                         auto_bucket=False)
    svc.warmup()
    return svc



def _blobs(n, seed, spread=0.3):
    x, y = gaussian_blobs(n=n, k=4, seed=seed, spread=spread, box=14.0)
    return x, y



# ------------------------------------------- parity with the reference
PARITY_KW = dict(stop="converged", max_iterations=80, damping=0.6,
                 levels=2, preference="median")
SERVICE_KW = dict(buckets=[(64, 2, 4), (128, 2, 4)], auto_bucket=False,
                  max_bucket_n=128, drift_halflife=16)



def _parity_services(**kw):
    """The same service, one of each package: JAX on the CPU, the port
    with device="cpu"."""
    from repro.serve.cluster import ClusterService as JService
    from repro.solver import SolveConfig as JConfig

    svc_kw = {**SERVICE_KW, **kw}
    ref = JService(config=JConfig(**PARITY_KW), **svc_kw)
    port = ClusterService(config=SolveConfig(**PARITY_KW, device="cpu"),
                          **svc_kw)
    return ref, port



def _parity_traffic(seed: int, overflow_stream: Optional[str] = "big"):
    """Seeded numpy requests: plain and stream-tagged micro-batch riders
    in both buckets, two overflow requests (N = 500 on stream
    ``overflow_stream``, N = 300 plain; max_bucket_n = 128), a single
    point; then, once the streams hold exemplars, fast-path riders, far
    points that push stream "a" past the drift threshold (its re-solve
    runs in the second drain) and a request whose deadline has already
    passed."""
    rng = np.random.default_rng(seed)
    first = []
    for i in range(10):
        n = int(rng.integers(20, 129))
        x, _ = gaussian_blobs(n=n, k=4, seed=seed * 100 + i, spread=0.3,
                              box=14.0)
        first.append((x, "a" if i % 3 == 0 else None, None))
    first.append((_blobs(500, seed=seed + 11)[0], overflow_stream, None))
    first.append((_blobs(300, seed=seed + 12)[0], None, None))
    first.append((np.zeros((1, 2), np.float32), None, None))
    base = first[0][0]
    far = (rng.normal(size=(60, 2)) * 0.3 + 80.0).astype(np.float32)
    second = [(base[:30], "a", None),
              (first[10][0][:50], overflow_stream, None),
              (far, "a", None), (_blobs(40, seed=seed + 13)[0], None, None),
              (base, None, 0.0)]
    return first, second



def _drive(svc, first, second):
    futs = [svc.submit(x, stream=s, deadline_ms=dl) for x, s, dl in first]
    svc.drain()
    futs += [svc.submit(x, stream=s, deadline_ms=dl)
             for x, s, dl in second]
    svc.drain()
    return [f.exception(timeout=60) or f.result() for f in futs]



def _counters(svc) -> dict:
    """Every ``ServiceStats`` field, and the cache's hits and misses
    (``compile_seconds`` is a time, not a counter)."""
    snap = svc.snapshot()
    out = {f.name: snap[f.name]
           for f in dataclasses.fields(type(svc.stats)) if f.name != "cache"}
    out["cache"] = {k: snap["cache"][k] for k in ("hits", "misses")}
    out["buckets"], out["compiled"] = snap["buckets"], snap["compiled"]
    return out



def _assert_same_responses(ref_out, port_out, *, same_s: bool,
                           pref_rel: float):
    """Every response alike. Decisions are exact, with two known
    differences (ROADMAP C2): the top-k sweeps' level sums round
    differently from XLA's, so a ``dense_topk`` trace may differ by a
    point or two a sweep even from the same S; and from points (``same_s``
    False) a solve that has not converged by ``max_iterations`` (top-k AP
    on blobs oscillates) follows the drift of S, so only its sweep count
    and flag are compared, and every trace may differ by a point or two
    a sweep (a border point or an inert padding row)."""
    assert len(ref_out) == len(port_out)
    for i, (want, got) in enumerate(zip(ref_out, port_out)):
        if isinstance(want, BaseException):
            assert type(got).__name__ == type(want).__name__, i
            continue
        assert (got.path, got.bucket, got.stream, got.generation) == (
            want.path, want.bucket, want.stream, want.generation), i
        settled = same_s or want.solve is None or want.solve.converged
        if settled:
            np.testing.assert_array_equal(got.labels, want.labels)
        if want.path == "assign":
            assert got.assign.drift == want.assign.drift
            assert (got.assign.resolve_triggered
                    == want.assign.resolve_triggered)
            np.testing.assert_array_equal(got.assign.exemplar_points,
                                          want.assign.exemplar_points)
            np.testing.assert_allclose(got.assign.best_sim,
                                       want.assign.best_sim,
                                       rtol=pref_rel, atol=1e-4)
            continue
        if want.solve is None:                 # the single point
            assert got.solve is None
            continue
        assert got.solve.backend == want.solve.backend
        assert got.solve.n_sweeps == want.solve.n_sweeps, i
        assert got.solve.converged == want.solve.converged, i
        if not settled:
            continue
        np.testing.assert_array_equal(got.solve.exemplars,
                                      want.solve.exemplars)
        if same_s and want.solve.backend != "dense_topk":
            np.testing.assert_array_equal(got.solve.trace,
                                          want.solve.trace)
        else:
            assert len(got.solve.trace) == len(want.solve.trace)
            assert np.abs(got.solve.trace.astype(np.int64)
                          - want.solve.trace).max(initial=0) <= 2, i



def _assert_same_streams(ref, port, pref_rel: float, streams=("a", "big")):
    for stream in streams:
        want, got = ref.stream_info(stream), port.stream_info(stream)
        assert got.pop("preference") == pytest.approx(
            want.pop("preference"), rel=pref_rel)
        assert got == want



@pytest.fixture
def reference_similarity(monkeypatch):
    """Feed the port the reference's similarity values: the batched
    handle's S and the top-k build's values come from the JAX functions
    on the same points. Everything downstream is the port's."""
    import jax.numpy as jnp

    from repro.core.similarity import pairwise_similarity as ref_sim
    from repro.solver.config import SolveConfig as JConfig
    from repro.solver.topk_build import build_topk_similarity as ref_build
    from repro_torch.solver import compiled, topk, topk_build

    def sim(x, metric="neg_sqeuclidean"):
        s = ref_sim(jnp.asarray(x.numpy()), metric=metric)
        return torch.from_numpy(np.array(s))

    def build(x, k, cfg):
        vals, idx = ref_build(jnp.asarray(x.numpy()), k,
                              JConfig(metric=cfg.metric))
        return (torch.from_numpy(np.array(vals)),
                torch.from_numpy(np.array(idx)))

    monkeypatch.setattr(compiled, "pairwise_similarity", sim)
    monkeypatch.setattr(topk, "build_topk_similarity", build)
    monkeypatch.setattr(topk_build, "build_topk_similarity", build)
