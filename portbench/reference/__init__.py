"""The plain reference the benchmark holds the port to.

Plain PyTorch and NumPy only: it imports nothing of ``repro_torch``,
``repro`` or JAX, and works out from the points alone everything the port
derives (similarities, top-k lists, preferences, the sweeps, the
exemplars). ``decisions`` is its one entry.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import hap, similarity
from portbench.reference.precision import identity


def random_preferences(n: int, seed: int, low: float, high: float
                       ) -> torch.Tensor:
    """The paper's random preferences, U[low, high] in float32, as the
    configuration states them: ``n`` draws of ``torch.rand`` on a CPU
    generator seeded with ``seed``, mapped as low + (high - low) u."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand(n, generator=gen, dtype=torch.float32)
    return low + (high - low) * u


def _preference(cfg: dict, s_or_vals: torch.Tensor, x: torch.Tensor,
                rnd, layout: str) -> torch.Tensor:
    """The preference as the configuration states it, in float32: a
    number, "random" (one draw a point, ``random_preferences``) or
    "median" (exact over every off-diagonal similarity on the dense
    layout; on the top-k layout past ``pref_exact_n`` points, of a
    ``pref_sample``-point subsample; else of the stored values). A scalar
    tensor, or (N,) for "random"."""
    pref = cfg["preference"]
    dev = x.device
    if not isinstance(pref, str):
        return rnd(torch.tensor(float(pref), dtype=torch.float32,
                                device=dev))
    if pref == "random":
        return rnd(random_preferences(x.shape[0], cfg["seed"],
                                      cfg["pref_low"], cfg["pref_high"])
                   .to(dev))
    if pref != "median":
        raise ValueError(f"unknown preference {pref!r}")
    if layout == "dense":
        return rnd(similarity.median_offdiag(s_or_vals))
    n = x.shape[0]
    if n > cfg["pref_exact_n"] and cfg["k"] < n - 1:
        sel = similarity.sample_rows(n, cfg["pref_sample"], cfg["seed"],
                                     cfg["pref_fold"]).to(dev)
        return rnd(similarity.median_offdiag(
            similarity.similarity_matrix(x[sel], rnd)))
    return rnd(similarity.median_values(s_or_vals))


def decisions(cfg: dict, points: np.ndarray, device, rnd=identity
              ) -> np.ndarray:
    """(L, N) canonical exemplars of a solve of ``points`` under ``cfg``
    (``programs.solve.reference_config``), worked out from the points alone;
    ``rnd`` rounds every step (``precision.tf32`` for the control)."""
    x = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)
    levels, sweeps, lam = cfg["levels"], cfg["sweeps"], cfg["damping"]
    if cfg["layout"] == "dense":
        s = similarity.similarity_matrix(x, rnd)
        s.diagonal().copy_(_preference(cfg, s, x, rnd, "dense"))
        s3 = s.expand(levels, *s.shape).contiguous()
        del s
        e = hap.dense_sweeps(s3, sweeps, lam, rnd)
    else:
        vals, idx = similarity.topk_lists(x, cfg["k"], rnd)
        pref = _preference(cfg, vals, x, rnd, "topk")
        n = x.shape[0]
        rows = torch.arange(n, dtype=torch.int32, device=x.device)
        s = torch.cat([pref.expand(n)[:, None], vals], dim=1)
        idx = torch.cat([rows[:, None], idx], dim=1)
        s3k = s.expand(levels, *s.shape).contiguous()
        e = hap.topk_sweeps(s3k, idx, sweeps, lam, rnd)
    return hap.canonical(e.cpu().numpy())
