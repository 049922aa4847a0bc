"""``coarsen`` backend: two-level partition -> local -> global solve (port
of ``repro/solver/coarsen.py``).

1. **partition** — the kd median-cut cells
   (``repro_torch.sharding.partitioning.kd_cells``): at most
   ``cfg.partition_size`` spatially-tight points per cell;
2. **local solves** — per-cell dense AP, ``cfg.coarsen_batch`` cells at a
   time through one ``BatchedDenseSolver`` handle (one bucket shape, kept
   at module level per config);
3. **global solve** — ``solve()`` over the union of local exemplars
   (``dense_parallel`` while E <= ``cfg.coarsen_global_dense_n``, else
   ``dense_topk`` with k = min(``cfg.coarsen_global_k``, E-1), whose build
   on the card is the fused top-k kernel), with preferences re-derived
   from partition masses: heavier local exemplars get preferences closer
   to zero;
4. **broadcast-assign** — every point to its nearest global exemplar via
   the row+column-chunked ``assign_nearest_exemplar`` shared with
   ``sharded_streaming``.

Each point inherits the full exemplar chain of its nearest global
exemplar (level 0 = its global exemplar, level l = that exemplar's level-l
exemplar). With a single partition (N <= partition_size) the local solve
*is* the dense oracle and the global stage is skipped.

Checkpoint/resume (``checkpoint_every``/``checkpoint_dir``/``resume_from``)
keeps per-stage artifacts, as the reference does: the kd partition is
deterministic, so only its products are saved — the local exemplar/mass
prefix every ``checkpoint_every`` batch groups, and the global solution,
so a crash in the broadcast-assign stage resumes after the global solve.

Where it differs from the reference: past ``PREF_EXACT_N`` exemplars the
global preference is the port's sampled estimate (``ROADMAP.md`` C3).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.assignments import canonicalize_levels
from repro_torch.core.streaming import assign_nearest_exemplar
from repro_torch.runtime import faultinject
from repro_torch.solver import checkpointing as ckp
from repro_torch.solver.compiled import (
    BatchedDenseSolver, config_static_key, slice_request,
)
from repro_torch.solver.config import (
    COARSEN_PREF_STRATEGIES, SolveConfig, coarsen_pref_ok,
)
from repro_torch.solver.result import RawBackendResult

#: target f32 elements per broadcast-assign row block — 32 MB blocks, so
#: the (N, E) matrix is never held.
_ASSIGN_BLOCK_ELEMS = 8 << 20

#: exemplar columns per assign block (bounds the f32 block width even
#: when the adaptive row chunk is tiny).
_ASSIGN_COL_CHUNK = 65536

#: module-level handle cache, keyed on (batch, bucket_n, d,
#: config_static_key): repeated coarsen solves reuse their handles.
_HANDLES: dict = {}

#: what the last ``run_coarsen`` did: kd cells, local exemplars E, and the
#: backend of the global stage (None when it was skipped)
last_run: dict = {}


def check_coarsen_config(cfg: SolveConfig) -> None:
    """Knob validation ``solve()`` runs at entry (``engine.validate_config``
    delegates here) — fail at the front door, not partitions deep."""
    if cfg.partition_size < 2:
        raise ValueError(
            f"SolveConfig.partition_size must be >= 2 "
            f"(got {cfg.partition_size})")
    if cfg.coarsen_batch < 1:
        raise ValueError(
            f"SolveConfig.coarsen_batch must be >= 1 "
            f"(got {cfg.coarsen_batch})")
    if cfg.coarsen_global_dense_n < 2 or cfg.coarsen_global_k < 1:
        raise ValueError(
            "SolveConfig.coarsen_global_dense_n must be >= 2 and "
            f"coarsen_global_k >= 1 (got {cfg.coarsen_global_dense_n}/"
            f"{cfg.coarsen_global_k})")
    if not coarsen_pref_ok(cfg.preference):
        raise ValueError(
            "the coarsen backend's batched local solves support "
            f"preference in {COARSEN_PREF_STRATEGIES} or a scalar; got "
            f"{cfg.preference!r} (draw 'random' host-side and pass the "
            "scalar; per-point arrays don't decompose over partitions)")


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


def _local_handle(batch: int, n: int, d: int,
                  cfg: SolveConfig) -> BatchedDenseSolver:
    key = (batch, n, d, config_static_key(cfg))
    h = _HANDLES.get(key)
    if h is None:
        h = _HANDLES[key] = BatchedDenseSolver(batch, n, d, cfg).compile()
    return h


def _global_preference(ex_pts: torch.Tensor, masses: np.ndarray,
                       cfg: SolveConfig):
    """Preference for the global exemplar solve, re-derived from
    partition masses.

    The base value is the configured strategy over the *exemplar* points
    (the exact dense statistic up to PREF_EXACT_N, the port's sampled
    estimate past it — the branches ``dense_topk`` itself takes). A
    negative base is rescaled per exemplar by ``mean_mass / mass_e``: an
    exemplar speaking for many points gets a preference nearer zero, a
    singleton a more negative one. A non-negative base stays uniform
    (scaling would flip its meaning).
    """
    from repro_torch.core.preferences import make_preferences
    from repro_torch.core.similarity import pairwise_similarity
    from repro_torch.solver.topk import (
        PREF_EXACT_N, sample_generator, sampled_preferences,
    )

    pref = cfg.preference
    if pref is None:
        return None
    if isinstance(pref, str):
        if len(ex_pts) <= PREF_EXACT_N:
            s = pairwise_similarity(ex_pts, metric=cfg.metric)
            base = float(make_preferences(s, pref)[0])
        else:
            base = float(sampled_preferences(
                ex_pts, pref, cfg.metric, sample_generator(cfg.seed))[0])
    else:
        base = float(pref)
    if base >= 0.0:
        return base
    m = masses.astype(np.float64)
    return (base * (m.mean() / m)).astype(np.float32)


def _trivial(n: int, levels: int) -> RawBackendResult:
    return RawBackendResult(
        exemplars=np.zeros((levels, n), np.int32), n_sweeps=0,
        converged=True, trace=None)


def run_coarsen(x, cfg: SolveConfig) -> RawBackendResult:
    """(N, d) points -> RawBackendResult via the two-level decomposition,
    on the device of ``x`` (a tensor) or on the CPU.

    The engine is imported lazily: it imports the registry, which imports
    this backend's adapter."""
    from repro_torch.sharding.partitioning import kd_cells
    from repro_torch.solver.engine import solve

    check_coarsen_config(cfg)
    xt = x.float() if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.asarray(x, np.float32))
    device = xt.device
    cfg = cfg.replace(device=str(device))
    x_np = xt.cpu().numpy()
    n, d = x_np.shape
    if n < 2:
        return _trivial(n, cfg.levels)

    # ---- checkpoint/resume plumbing: the kd partition is deterministic,
    # so stage artifacts only need the *products* (exemplar prefix, then
    # the global solution); everything else is recomputed on resume.
    ckpt_every = cfg.checkpoint_every
    ckpt_dir = cfg.checkpoint_dir if ckpt_every > 0 else None
    local_art = global_art = None
    if ckpt_dir or cfg.resume_from:
        meta = ckp.coarsen_meta(n, d, cfg)
        if cfg.resume_from:
            ckp.check_meta(cfg.resume_from, meta)
            local_art = ckp.load_stage(
                cfg.resume_from, "local",
                {"ex_idx": 0, "masses": 0, "groups_done": 0,
                 "local_sweeps": 0, "local_conv": 0})
            global_art = ckp.load_stage(
                cfg.resume_from, "global",
                {"exemplars": 0, "n_sweeps": 0, "converged": 0})
        if ckpt_dir:
            if not cfg.resume_from or os.path.abspath(cfg.resume_from) \
                    != os.path.abspath(ckpt_dir):
                ckp.reset_dir(ckpt_dir)
            ckp.write_meta(ckpt_dir, meta)
        # the sub-solves (batched locals, the global stage) must not
        # inherit the checkpoint knobs: they'd collide on the same dir
        cfg = cfg.replace(checkpoint_every=0, checkpoint_dir=None,
                          resume_from=None)

    cells = kd_cells(x_np, cfg.partition_size)
    last_run.clear()
    last_run.update(cells=len(cells), exemplars=None, global_backend=None)

    # ---- single partition: the local solve IS the dense oracle (cell 0
    # is the identity ordering; bucket n == n, so not even padding
    # separates it from dense_parallel on the same points)
    if len(cells) == 1:
        local = cfg.replace(backend="dense_parallel", k=None,
                            input_kind="points")
        h = _local_handle(1, n, d, local)
        raw = h.run(x_np[None], np.asarray([n], np.int32))
        rbr, _ = slice_request(raw, 0, n, cfg.stop)
        return rbr

    # ---- local solves: one output level per cell (the hierarchy is the
    # global stage's job), batched through one bucket shape
    singles = [c for c in cells if len(c) == 1]
    multi = [c for c in cells if len(c) > 1]
    max_sz = max(len(c) for c in multi) if multi else 2
    bucket_n = max(min(_next_pow2(max_sz), cfg.partition_size), max_sz, 2)
    batch = max(min(cfg.coarsen_batch, len(multi)), 1)
    local = cfg.replace(backend="dense_parallel", levels=1, k=None,
                        input_kind="points")
    h = _local_handle(batch, bucket_n, d, local)

    ex_idx: list[np.ndarray] = []      # global point index per exemplar
    masses: list[np.ndarray] = []      # points each exemplar speaks for
    local_sweeps, local_converged = 0, True
    n_groups = (len(multi) + batch - 1) // batch
    groups_done = 0
    if local_art is not None:
        ex_idx.append(np.asarray(local_art["ex_idx"]))
        masses.append(np.asarray(local_art["masses"]))
        groups_done = int(local_art["groups_done"])
        local_sweeps = int(local_art["local_sweeps"])
        local_converged = bool(local_art["local_conv"])

    def _save_local(done: int) -> None:
        ckp.save_stage(ckpt_dir, "local", {
            "ex_idx": np.concatenate(ex_idx) if ex_idx
            else np.zeros((0,), np.int64),
            "masses": np.concatenate(masses) if masses
            else np.zeros((0,), np.int64),
            "groups_done": np.int64(done),
            "local_sweeps": np.int64(local_sweeps),
            "local_conv": np.int64(local_converged)})

    for lo in range(groups_done * batch, len(multi), batch):
        group = multi[lo:lo + batch]
        pts = np.zeros((batch, bucket_n, d), np.float32)
        n_real = np.full((batch,), 2, np.int32)     # inert filler slots
        for i, cell in enumerate(group):
            pts[i, :len(cell)] = x_np[cell]
            n_real[i] = len(cell)
        raw = h.run(pts, n_real)
        for i, cell in enumerate(group):
            rbr, _ = slice_request(raw, i, len(cell), cfg.stop)
            e0 = canonicalize_levels(np.asarray(rbr.exemplars))[0]
            uniq, inv = np.unique(e0, return_inverse=True)
            ex_idx.append(cell[uniq])
            masses.append(np.bincount(inv).astype(np.int64))
            local_sweeps = max(local_sweeps, rbr.n_sweeps)
            if rbr.converged is False:
                local_converged = False
        groups_done += 1
        if ckpt_dir and (groups_done % ckpt_every == 0
                         or groups_done == n_groups):
            _save_local(groups_done)
            faultinject.fire("solver.coarsen", stage="local",
                             group=groups_done)
    for c in singles:                   # a lone point is its own exemplar
        ex_idx.append(c)
        masses.append(np.ones((1,), np.int64))

    ex_idx = np.concatenate(ex_idx)
    masses = np.concatenate(masses)
    ex_pts = xt[torch.from_numpy(ex_idx.astype(np.int64)).to(device)]
    n_ex = len(ex_idx)
    last_run["exemplars"] = n_ex

    if n_ex == 1:
        e_out = np.broadcast_to(
            np.int32(ex_idx[0]), (cfg.levels, n)).copy()
        conv = local_converged if cfg.stop == "converged" else None
        return RawBackendResult(exemplars=e_out, n_sweeps=local_sweeps,
                                converged=conv, trace=None)

    # ---- global solve over the exemplar union, mass-derived preferences
    if global_art is not None:
        # stage-3 resume: the global solution is already on disk
        g_exemplars = np.asarray(global_art["exemplars"])
        g_sweeps = int(global_art["n_sweeps"])
        g_conv_i = int(global_art["converged"])
        g_converged = None if g_conv_i < 0 else bool(g_conv_i)
    else:
        if n_ex <= cfg.coarsen_global_dense_n:
            gcfg = cfg.replace(backend="dense_parallel", k=None)
        else:
            gcfg = cfg.replace(backend="dense_topk",
                               k=min(cfg.coarsen_global_k, n_ex - 1))
        gcfg = gcfg.replace(
            input_kind="points",
            preference=_global_preference(ex_pts, masses, cfg))
        last_run["global_backend"] = gcfg.backend
        gres = solve(ex_pts, gcfg)
        g_exemplars = np.asarray(gres.exemplars)
        g_sweeps, g_converged = gres.n_sweeps, gres.converged
        if ckpt_dir:
            ckp.save_stage(ckpt_dir, "global", {
                "exemplars": g_exemplars.astype(np.int64),
                "n_sweeps": np.int64(g_sweeps),
                "converged": np.int64(
                    -1 if g_converged is None else int(g_converged))})
            faultinject.fire("solver.coarsen", stage="global")

    # ---- broadcast-assign: nearest global exemplar, row+column chunked
    g_uniq = np.unique(g_exemplars[0])
    row_chunk = int(max(256, min(65536,
                                 _ASSIGN_BLOCK_ELEMS // max(len(g_uniq), 1))))
    labels, _ = assign_nearest_exemplar(
        xt, ex_pts[torch.from_numpy(g_uniq.astype(np.int64)).to(device)],
        chunk=row_chunk, col_chunk=_ASSIGN_COL_CHUNK)
    labels = labels.cpu().numpy()

    # level l exemplar of point i = its global exemplar's own level-l
    # exemplar — the two coarsen tiers spliced into the HAP hierarchy
    e_out = ex_idx[g_exemplars[:, g_uniq[labels]]].astype(np.int32)

    n_sweeps = max(local_sweeps, g_sweeps)
    conv = None
    if cfg.stop == "converged":
        conv = bool(local_converged and bool(g_converged))
    return RawBackendResult(exemplars=e_out, n_sweeps=n_sweeps,
                            converged=conv, trace=None)
