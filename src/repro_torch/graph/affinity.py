"""``graph_affinity`` — Borůvka-style affinity clustering on edge lists
(port of ``repro/graph/affinity.py``, the single-device program).

The MapReduce affinity-clustering loop of Ene et al. (*Fast Clustering
using MapReduce*, PAPERS.md): every round each current cluster selects
its best outgoing edge, clusters hook along the selected edges, and
pointer jumping contracts the hooking forest to its roots — O(N·k) work
per round, ~log N rounds to any target granularity. On similarity
weights (larger is better) "best" is the *maximum*-weight edge.

Deterministic selection rule (the tie-break contract):

    best edge of cluster c = max weight, then min destination-leader id

— the (value desc, col asc) order of every top-k path. On a symmetrized
edge list this rule admits no hooking cycle longer than 2, and mutual
2-cycles resolve to the smaller node id, so pointer jumping reaches a
fixed point in <= ceil(log2 N) doublings. ``EdgeList.canonical()``
(applied by the backend adapter) establishes symmetry.

The round loop is a Python loop of plain torch ops on the device of the
edge layout. The two segment reductions are ``scatter_reduce`` with
``amax`` (f32) and ``amin`` (int64) — chosen over ``kernels/topk_ops.py``'s
fixed-order segment sums because a max or a min is exact in any order:
the atomics of the CUDA scatter cannot change the result, and ±0 does not
matter, since the achievers of the max are found by ``==``. Each round
makes one host read, the stop test (the relabel count and the cluster
count in one transfer), counted in ``host_copies.graph_affinity`` of
``repro_torch.obs``.

The hierarchy output reuses the HAP convention: level ``l`` of the
``(levels, N)`` exemplar stack is the label snapshot ``levels-1-l``
rounds before the stop round (level 0 finest, earlier snapshots padded
with the initial all-singletons labeling when the loop stops in fewer
than ``levels`` rounds).

Execution shapes, as in the reference:

* one device: the round loop over the whole (N, D) layout;
* sharded (``mesh``, a 1-D ``workers`` mesh over the ranks of a
  ``torch.distributed`` group): the layout is padded to a rank multiple
  with inert rows (``pad_rows``) and each rank owns a row block; labels
  stay replicated. A round's selection is two collectives: ``pmax`` of
  the per-cluster best weight (an f32 max, exact in any order), then each
  rank scores its own achievers of that global best and ``pmin`` reduces
  the candidate destination-leader (an int32 min, also exact). Every rank
  therefore holds the one-device loop's labels bit for bit, reads the
  same stop-test value each round, and stops on the same round.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.sharding import dist
from repro_torch.sharding.partitioning import row_block

AXIS = "workers"

def default_rounds(n: int) -> int:
    """Round budget when ``SolveConfig.graph_rounds`` is None: Borůvka
    at least halves the cluster count per round, so ceil(log2 N) + 1
    covers contraction to a single component with one slack round."""
    return int(math.ceil(math.log2(max(n, 2)))) + 1


def _jump_iters(n: int) -> int:
    return int(math.ceil(math.log2(max(n, 2)))) + 1


def _hook_and_jump(best_t: torch.Tensor, n_total: int,
                   jump_iters: int) -> torch.Tensor:
    """Selected destination-leader per cluster -> contracted root map.

    2-cycles (mutual best edges — guaranteed to exist on the max-weight
    edge of any component, so every round makes progress) keep the
    smaller node id as root; the jump count is fixed, so the contraction
    makes no host read."""
    ids = torch.arange(n_total, device=best_t.device)
    parent = torch.where(best_t < n_total, best_t, ids)
    two_cycle_root = (parent[parent] == ids) & (ids < parent)
    parent = torch.where(two_cycle_root, ids, parent)
    for _ in range(jump_iters):
        parent = parent[parent]
    return parent


def _select_fn(vals, idx, labels, rows, n_total):
    """Per-cluster best weight over one row block: ``rows`` are the
    block's global node ids; edges whose endpoints share a leader
    (including the padding's self-pointing slots) are inactive (-inf)."""
    b, d = vals.shape
    row_lbl = labels[rows]                          # (B,) leader per row
    dst_lbl = labels[idx]                           # (B, D) relabeled edges
    active = dst_lbl != row_lbl[:, None]
    seg = row_lbl[:, None].expand(b, d).reshape(-1)
    w = torch.where(active, vals, float("-inf")).reshape(-1)
    best_w = torch.full((n_total,), float("-inf"), dtype=w.dtype,
                        device=w.device).scatter_reduce(
        0, seg, w, reduce="amax", include_self=True)
    return seg, w, best_w, dst_lbl.reshape(-1)


def _candidates(seg, w, best_w, dst_flat, n_total):
    """Min destination-leader among the achievers of each cluster's best
    weight; ``n_total`` where a cluster has no finite edge."""
    ach = (w == best_w[seg]) & torch.isfinite(w)
    cand = torch.where(ach, dst_flat, n_total)
    return torch.full((n_total,), n_total, dtype=cand.dtype,
                      device=cand.device).scatter_reduce(
        0, seg, cand, reduce="amin", include_self=True)


def _loop(select, levels: int, n: int, n_real: int, max_rounds: int,
          target: int, jump_iters: int, device):
    """The round loop: stop at the round budget, at ``target`` clusters or
    when a round relabels nothing; only the first ``n_real`` nodes count
    (the rest are padding). Returns ``(hist, rounds, converged, trace)``
    with ``hist`` a list of the last ``levels`` label snapshots."""
    ids = torch.arange(n, device=device)
    real = ids < n_real
    labels = ids
    hist = [labels] * levels
    trace = np.zeros((max_rounds,), np.int32)
    r, changes, clusters = 0, 1, n_real
    while r < max_rounds and clusters > target and (r == 0 or changes > 0):
        parent = _hook_and_jump(select(labels), n, jump_iters)
        new = parent[labels]
        stats = torch.stack([((new != labels) & real).sum(),
                             ((new == ids) & real).sum()])
        # the round's host read
        changes, clusters = obs.to_host(stats, "graph_affinity").tolist()
        hist = hist[1:] + [new]
        trace[r] = changes
        labels = new
        r += 1
    converged = clusters <= target or (r > 0 and changes == 0)
    return hist, r, converged, trace


def pad_rows(vals: torch.Tensor, idx: torch.Tensor, multiple: int):
    """Pad the (N, D) row layout to a rank multiple with inert rows: every
    padded slot points at its own (padded) row, so the padding is an
    isolated singleton forever and never enters a real selection (its
    edges are inactive, and no real row points at it). Returns ``(vals,
    idx, original N)``; a layout that already splits comes back as it
    is."""
    n, d = vals.shape
    pad = (-n) % multiple
    if pad == 0:
        return vals, idx, n
    dummy = torch.arange(n, n + pad, dtype=idx.dtype, device=idx.device)
    return (torch.cat([vals, vals.new_zeros((pad, d))]),
            torch.cat([idx, dummy[:, None].expand(pad, d)]), n)


def run_graph_affinity(vals, idx, *, levels: int = 1,
                       max_rounds: Optional[int] = None, target: int = 1,
                       mesh=None):
    """Run Borůvka affinity clustering on a padded row layout.

    ``vals``/``idx`` are the ``EdgeList.to_topk()`` layout: (N, D)
    weights and destination ids, inert slots pointing at their own row,
    as tensors (the loop runs on their device) or numpy arrays (on the
    CPU). Returns ``(hist, n_rounds, converged, trace)`` — ``hist`` the
    (levels, N) int32 label-snapshot tensor (level 0 finest), ``trace`` the
    per-round relabel count (numpy, slice by ``n_rounds``).

    ``mesh`` (a 1-D ``workers`` mesh; every rank passes the whole layout)
    selects the sharded program; its ``hist`` is in the padded N' (the
    engine strips the padding), and every result equals the one-device
    loop's bit for bit."""
    vals = torch.as_tensor(vals).float()
    idx = torch.as_tensor(idx, device=vals.device).long()
    n, _ = vals.shape
    max_rounds = default_rounds(n) if max_rounds is None else int(max_rounds)
    target = max(int(target), 1)
    jump = _jump_iters(n)
    if mesh is None or mesh.shape.get(AXIS, 1) == 1:
        rows = torch.arange(n, device=vals.device)

        def select(labels):
            seg, w, best_w, dst = _select_fn(vals, idx, labels, rows, n)
            return _candidates(seg, w, best_w, dst, n)

        n_total, n_real = n, n
    else:
        if tuple(mesh.axis_names) != (AXIS,):
            raise ValueError(
                f"graph_affinity needs a 1-D mesh with axis {AXIS!r} "
                f"(got axes {tuple(mesh.axis_names)}); build one with "
                "repro_torch.launch.mesh.make_worker_mesh()")
        ax = mesh.axis(AXIS)
        vals_p, idx_p, n_real = pad_rows(vals, idx, ax.size)
        n_total = vals_p.shape[0]
        vals_loc = row_block(vals_p, mesh, AXIS)
        idx_loc = row_block(idx_p, mesh, AXIS)
        b = vals_loc.shape[0]
        rows = ax.index * b + torch.arange(b, device=vals.device)

        def select(labels):
            seg, w, best_w_loc, dst = _select_fn(vals_loc, idx_loc, labels,
                                                 rows, n_total)
            best_w = dist.pmax(best_w_loc, ax)           # exact f32 max
            cand = _candidates(seg, w, best_w, dst, n_total)
            # exact int32 min: candidates are node ids < n_total
            return dist.pmin(cand.to(torch.int32), ax).long()

    hist, r, conv, trace = _loop(select, levels, n_total, n_real, max_rounds,
                                 target, jump, vals.device)
    return torch.stack(hist).to(torch.int32), r, conv, trace


# ----------------------------------------------------------------- preseed
#: per-row edge cap for the preseed pass — the symmetrized graph can
#: concentrate unbounded in-degree on hub rows; the seeding only needs
#: each row's strongest edges.
PRESEED_MAX_DEGREE = 128


def preseed_preferences(vals, idx, base, *,
                        target: Optional[int] = None,
                        max_rounds: Optional[int] = None) -> torch.Tensor:
    """A cheap graph pass to seed HAP preferences: one Borůvka clustering
    over the already-built top-k edges (no second O(N^2) build), then bias
    the preference vector so graph-cluster leaders are the favored
    exemplar candidates — leaders keep ``base``, members pay a
    stored-weight-span penalty. ``target`` defaults to ~sqrt(N) seed
    clusters. ``vals``/``idx`` are (N, k) tensors; the contraction runs on
    their device, the canonicalization on the host as in the reference."""
    from repro_torch.graph.edges import EdgeList

    vals_np = vals.detach().cpu().numpy()
    n, k = vals_np.shape
    el = EdgeList.from_topk(vals_np, idx.detach().cpu().numpy()).canonical()
    cap = min(el.max_degree or 1, max(2 * k, 8))
    tv, ti = el.to_topk(cap)
    if target is None:
        target = max(int(math.sqrt(n)), 2)
    device = vals.device
    hist, _, _, _ = run_graph_affinity(
        torch.from_numpy(tv).to(device), torch.from_numpy(ti).to(device),
        levels=1, max_rounds=max_rounds, target=target)
    labels = hist[-1]
    leaders = labels == torch.arange(n, dtype=labels.dtype, device=device)
    span = (float(vals_np.max()) - float(vals_np.min())
            if vals_np.size else 1.0)
    base = torch.as_tensor(base, dtype=torch.float32,
                           device=device).expand(n)
    return torch.where(leaders, base,
                       base - torch.tensor(np.float32(span), device=device))
