"""Big-N clustering beyond the O(N^2) similarity budget (port of
``repro/core/streaming.py``).

  shard-level AP  : partition the N points into S shards (each
                    O((N/S)^2)), flat AP in each;
  exemplar-level  : flat AP over the union of shard exemplars;
  assignment      : each point inherits its shard exemplar's cluster, then
                    a second pass reassigns every point to its nearest
                    *global* exemplar.

The shards are drawn with the reference's numpy calls
(``np.random.default_rng(seed).permutation(n)``), so both packages cut the
same shards and can reach the same decisions. The solves run in PyTorch on
the device of the points they are given; what the host needs (each tier's
exemplar labels, the final assignment) it reads back, and every such read
adds one to the counter ``host_copies.streaming`` of ``repro_torch.obs``.

``converged_ap`` adds the paper's "run until convergence" stopping rule:
exemplar assignments stable for ``patience`` sweeps. The reference's
``lax.while_loop`` is a Python loop here, reading the stability test on
the host once per sweep.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.affinity import (
    APState, affinity_propagation, availability_update, responsibility_update,
)
from repro_torch.core.assignments import canonicalize
from repro_torch.core.preferences import median_preference
from repro_torch.core.similarity import pairwise_similarity, set_preferences

class StreamingResult(NamedTuple):
    labels: np.ndarray          # (N,) global cluster ids
    exemplar_points: np.ndarray  # (K, d) chosen exemplar coordinates
    shard_exemplars: np.ndarray  # (N,) index of each point's shard exemplar
    n_clusters: int
    exemplar_of: np.ndarray     # (N,) point index of each point's exemplar


def _points(x) -> torch.Tensor:
    """Points as a float32 tensor: a tensor stays on its device, anything
    else lands on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.asarray(x, np.float32))


def _sq_dist(a: torch.Tensor, b: torch.Tensor, a_sq: torch.Tensor,
             b_sq: torch.Tensor) -> torch.Tensor:
    """(len(a), len(b)) squared distances ``a_sq + b_sq - 2 a.b``, the dot
    summed over features in ascending order, each product and sum rounded
    once: no matmul, whose order (and FMAs) would depend on the block's
    shape, so every row and column chunking gives the same bits."""
    dot = a[:, None, 0] * b[None, :, 0]
    for f in range(1, a.shape[1]):
        dot = dot + a[:, None, f] * b[None, :, f]
    return (a_sq[:, None] + b_sq[None, :]) - 2.0 * dot


def _sq_norms(a: torch.Tensor) -> torch.Tensor:
    acc = a[:, 0] * a[:, 0]
    for f in range(1, a.shape[1]):
        acc = acc + a[:, f] * a[:, f]
    return acc


def assign_nearest_exemplar(
    x, exemplar_points, *, chunk: int = 4096, col_chunk: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Second-pass assignment: each point to its nearest exemplar.

    The identity ``||c - e||^2 = ||c||^2 + ||e||^2 - 2 c.e`` over row
    blocks of ``chunk`` points and, with ``col_chunk`` set, column blocks
    of that many exemplars keeps peak state at O(chunk * col_chunk). Within
    a block ``torch.argmin`` takes the first minimum; column blocks merge
    with a strict ``<``, so an earlier block keeps its ties, and the
    chunked result equals the unchunked one bit for bit. Runs on the
    device of ``x`` (a tensor) or on the CPU. Returns ``(labels,
    best_sim)`` as tensors on that device: ``labels[i]`` (int32) indexes
    ``exemplar_points`` and ``best_sim[i] = -max(min_e ||x_i - e||^2, 0)``.
    """
    xt = _points(x)
    ex = _points(exemplar_points).to(xt.device)
    n, n_ex = xt.shape[0], ex.shape[0]
    cb = n_ex if col_chunk is None else max(int(col_chunk), 1)
    ex_sq = _sq_norms(ex)
    labels = torch.empty(n, dtype=torch.int32, device=xt.device)
    best = torch.empty(n, dtype=torch.float32, device=xt.device)
    for lo in range(0, n, chunk):
        blk = xt[lo:lo + chunk]
        blk_sq = _sq_norms(blk)
        best_d2 = torch.full((blk.shape[0],), float("inf"),
                             device=xt.device)
        best_lab = torch.zeros(blk.shape[0], dtype=torch.int32,
                               device=xt.device)
        for clo in range(0, n_ex, cb):
            d2 = _sq_dist(blk, ex[clo:clo + cb], blk_sq, ex_sq[clo:clo + cb])
            arg = d2.argmin(dim=1)
            val = d2.gather(1, arg[:, None])[:, 0]
            upd = val < best_d2          # strict: earlier block keeps ties
            best_lab = torch.where(upd, (arg + clo).to(torch.int32),
                                   best_lab)
            best_d2 = torch.where(upd, val, best_d2)
        labels[lo:lo + chunk] = best_lab
        best[lo:lo + chunk] = -best_d2.clamp_min(0.0)
    return labels, best


def _to_host(t: torch.Tensor) -> np.ndarray:
    return obs.to_host(t, "streaming").numpy()


def _ap_labels(x: torch.Tensor, iterations: int, damping: float,
               pref_scale: float = 1.0) -> np.ndarray:
    """Flat AP on ``x`` with the exact median preference (times
    ``pref_scale``); canonical exemplar labels on the host. A single point
    is its own exemplar (the reference's NaN preference gives the same)."""
    if x.shape[0] == 1:
        return np.zeros(1, np.int32)
    s = pairwise_similarity(x)
    s = set_preferences(s, median_preference(s) * pref_scale)
    res = affinity_propagation(s, iterations=iterations, damping=damping)
    return canonicalize(_to_host(res.exemplars))


def streaming_hap(
    x, *, shard_size: int = 512, iterations: int = 80,
    damping: float = 0.7, pref_scale: float = 1.0, seed: int = 0,
) -> StreamingResult:
    """Two-tier exemplar clustering with O(shard_size^2) peak state, on the
    device of ``x`` (a tensor) or on the CPU."""
    xt = _points(x)
    n = xt.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    shards = [perm[i:i + shard_size] for i in range(0, n, shard_size)]

    def rows(idx: np.ndarray) -> torch.Tensor:
        return xt[torch.from_numpy(np.asarray(idx, np.int64)).to(xt.device)]

    # ---- tier 1: per-shard AP (each shard independent => MapReduce map)
    shard_exemplar_of = np.zeros(n, np.int64)
    exemplar_idx: list[np.ndarray] = []
    for idx in shards:
        e_local = _ap_labels(rows(idx), iterations, damping, pref_scale)
        shard_exemplar_of[idx] = idx[e_local]
        exemplar_idx.append(np.unique(idx[e_local]))
    exemplar_idx = np.unique(np.concatenate(exemplar_idx))

    # ---- tier 2: AP over the exemplar union (the paper's upper level)
    e2 = _ap_labels(rows(exemplar_idx), iterations, damping, pref_scale)
    top_exemplars = exemplar_idx[e2]                       # point index
    final_exemplar = top_exemplars[np.searchsorted(exemplar_idx,
                                                   shard_exemplar_of)]
    uniq = np.unique(final_exemplar)

    # ---- second assignment pass: every point to its nearest global
    # exemplar (each exemplar is at distance 0 from itself, so the
    # exemplar set and n_clusters are unchanged)
    uniq_pts = rows(uniq)
    labels, _ = assign_nearest_exemplar(xt, uniq_pts)
    labels = _to_host(labels)
    final_exemplar = uniq[labels]
    return StreamingResult(labels, uniq_pts.cpu().numpy(),
                           shard_exemplar_of, len(uniq),
                           final_exemplar.astype(np.int32))


# -------------------------------------------------------- convergence AP
class ConvergedAP(NamedTuple):
    exemplars: torch.Tensor     # (N,) int32
    n_iterations: int           # sweeps actually run
    converged: bool


def converged_ap(
    s: torch.Tensor, *, max_iterations: int = 500, patience: int = 25,
    damping: float = 0.7,
) -> ConvergedAP:
    """Flat AP with the paper's stopping rule: stop once the exemplar
    assignment is unchanged for ``patience`` consecutive sweeps (bounded
    by ``max_iterations``). One host read per sweep decides whether to
    go on."""
    s = s.float()
    n = s.shape[-1]
    state = APState(torch.zeros_like(s), torch.zeros_like(s))
    e = torch.full((n,), -1, dtype=torch.int32, device=s.device)
    stable = it = 0
    while it < max_iterations and stable < patience:
        r = damping * state.r + (1.0 - damping) * responsibility_update(
            s, state.a)
        a = damping * state.a + (1.0 - damping) * availability_update(r)
        state = APState(r, a)
        e_new = torch.argmax(a + r, dim=1).to(torch.int32)
        same = bool(obs.to_host((e_new == e).all(), "streaming"))
        stable = stable + 1 if same else 0
        e = e_new
        it += 1
    return ConvergedAP(e, it, stable >= patience)
