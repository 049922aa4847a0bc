"""Solver checkpoint/resume: sweep segments and per-stage artifacts (port
of ``repro/solver/checkpointing.py``).

The two long-running backends take ``SolveConfig.checkpoint_every`` /
``checkpoint_dir`` / ``resume_from``:

* **dense_topk** (one device, or row-sharded) — the Jacobi loop runs as
  *segments* of ``dense.drive_sweeps`` (``segmented=True``); between
  segments the host snapshots the compressed message state and the loop
  counters through ``repro_torch.checkpoint``. A plain solve is one segment of the same
  loop with the same sweep (``topk.make_topk_sweep``), so an interrupted
  and resumed run, an uninterrupted checkpointed run and the plain run
  execute the same sweeps on the same state: resume is bit-exact by
  construction, the state included.
* **coarsen** — per-stage artifacts (``coarsen_meta``, ``save_stage``,
  ``load_stage``, used by ``solver/coarsen.py``): the local-solve prefix
  every ``checkpoint_every`` batch groups, and the global solution.

Every checkpoint directory carries a ``solve_meta.json`` sidecar with the
reference's keys and ``kind`` names; ``resume_from`` refuses a mismatched
run with the reference's message. The directories are the reference's
format (``repro_torch.checkpoint``), so a run checkpointed by either
package resumes in the other. Crash points are exercised through
``repro_torch.runtime.faultinject`` (sites ``solver.sweep`` and
``solver.coarsen``), fired *after* each save, so an injected crash always
leaves a resumable directory.

Sharded sweeps (``sweep="sharded"`` in a group of ranks) checkpoint the
*unpadded logical* state, as the reference does: at a segment boundary
the ranks gather their row blocks, the mesh's first rank alone writes the
directory, and every rank waits at a barrier before the fault site fires,
so an injected crash always leaves a complete directory and no rank runs
ahead of the write. On resume every rank reads the directory and re-pads
its own block (``_repad_carry``): real rows from disk, dummy rows at
their ``hap_init`` values. The dummies only reference themselves and the
change counter masks them out, so the real rows evolve as in the
uninterrupted run, bit for bit. Each segment runs the sweep closure of
``topk_sharded.prepare_sharded``, the one the plain sharded run uses.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (
    CheckpointManager, restore_tree, save_tree,
)
from repro_torch.core import hap
from repro_torch.runtime import faultinject
from repro_torch.sharding.dist import all_gather, barrier
from repro_torch.solver import dense, topk
from repro_torch.solver import topk_sharded as ts
from repro_torch.solver.config import (  # noqa: F401  (re-exported)
    CHECKPOINT_BACKENDS, SolveConfig,
)
from repro_torch.solver.topk import TopKState

META_NAME = "solve_meta.json"


# ------------------------------------------------------------- meta sidecar
def write_meta(directory: str, meta: dict) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, META_NAME), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)


def check_meta(directory: str, meta: dict) -> None:
    """Refuse to resume a directory written by a different run shape."""
    path = os.path.join(directory, META_NAME)
    if not os.path.exists(path):
        raise ValueError(
            f"resume_from={directory!r} has no {META_NAME}: not a solver "
            "checkpoint directory (or the initial save never completed)")
    with open(path) as f:
        stored = json.load(f)
    if stored != meta:
        diff = {k: (stored.get(k), meta.get(k))
                for k in sorted(set(stored) | set(meta))
                if stored.get(k) != meta.get(k)}
        raise ValueError(
            "checkpoint/config mismatch — refusing to resume "
            f"{directory!r}; differing keys (stored, requested): {diff}")


def reset_dir(directory: str) -> None:
    """Fresh checkpointed run: clear any previous run's artifacts so a
    later resume can't mix runs."""
    if not os.path.isdir(directory):
        return
    for name in os.listdir(directory):
        if name == META_NAME or name.startswith("step_") \
                or name in ("local", "global"):
            full = os.path.join(directory, name)
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
            else:
                os.remove(full)


def _topk_meta(kind: str, n: int, kk: int, cfg: SolveConfig,
               workers: int, exchange: Optional[str]) -> dict:
    return {
        "kind": kind, "n": n, "kk": kk, "levels": cfg.levels,
        "max_iterations": cfg.max_iterations, "damping": cfg.damping,
        "kappa": cfg.kappa, "s_mode": cfg.s_mode, "stop": cfg.stop,
        "patience": cfg.patience, "workers": workers, "exchange": exchange,
    }


# --------------------------------------------------- single-device segments
def _carry_tree(state: hap.HAPState, e, stable: int, it: int, trace) -> dict:
    """The saved carry: the reference's keys, leaves gathered to numpy
    (``stable`` and ``it`` as 0-d int32, as the reference writes them)."""
    return {"s": state.s, "r": state.r, "a": state.a, "tau": state.tau,
            "phi": state.phi, "c": state.c, "e_prev": e,
            "stable": np.int32(stable), "it": np.int32(it), "trace": trace}


def _carry_like() -> dict:
    z = np.int32(0)
    return {k: z for k in ("s", "r", "a", "tau", "phi", "c", "e_prev",
                           "stable", "it", "trace")}


def carry_from_tree(restored: dict, device="cpu"):
    """A restored carry tree -> ``(HAPState, e_prev, stable, it, trace)``
    as ``dense.drive_sweeps`` takes it: the state and ``e_prev`` as
    tensors on ``device``, ``stable`` and ``it`` as ints, ``trace`` numpy."""
    def t(name, dtype):
        return torch.from_numpy(np.asarray(restored[name], dtype)).to(device)

    state = hap.HAPState(*(t(f, np.float32) for f in hap.HAPState._fields))
    return (state, t("e_prev", np.int32), int(restored["stable"]),
            int(restored["it"]), np.asarray(restored["trace"], np.int32))


def _is_done(it: int, stable: int, cfg: SolveConfig) -> bool:
    return it >= cfg.max_iterations or (
        cfg.stop == "converged" and stable >= cfg.patience)


def run_topk_checkpointed(s3k: torch.Tensor, idx: torch.Tensor,
                          cfg: SolveConfig, *, mesh=None):
    """Checkpoint-aware replacement for ``topk.run_topk`` and
    ``topk_sharded.run_topk_sharded``, with their return contract
    ``(TopKState, exemplars, n_sweeps, converged, trace)`` (with a mesh:
    exemplars in the padded N', the state this rank's row block)."""
    if mesh is not None:
        return _run_sharded_checkpointed(s3k, idx, mesh, cfg)
    return _run_single_checkpointed(s3k, idx, cfg)


def _restore(cfg: SolveConfig, meta: dict):
    """The newest carry tree of ``cfg.resume_from`` (None without one),
    after checking its meta."""
    if not cfg.resume_from:
        return None
    check_meta(cfg.resume_from, meta)
    hit = CheckpointManager(cfg.resume_from, keep=2,
                            async_save=False).restore_latest(_carry_like())
    if hit is None:
        raise ValueError(
            f"resume_from={cfg.resume_from!r} holds no step_* "
            "checkpoints to resume")
    return hit[1]


def _open_writer(cfg: SolveConfig, meta: dict):
    """Initialize the checkpoint directory (clear another run's artifacts,
    write the meta) and return its manager; None without checkpointing."""
    if cfg.checkpoint_every <= 0:
        return None
    if not cfg.resume_from or \
            os.path.abspath(cfg.resume_from) != \
            os.path.abspath(cfg.checkpoint_dir):
        reset_dir(cfg.checkpoint_dir)
    write_meta(cfg.checkpoint_dir, meta)
    return CheckpointManager(cfg.checkpoint_dir, keep=2, async_save=False)


def _run_single_checkpointed(s3k: torch.Tensor, idx: torch.Tensor,
                             cfg: SolveConfig):
    s3k = s3k.float().contiguous()
    levels, n, kk = s3k.shape
    meta = _topk_meta("dense_topk_single", n, kk, cfg, 1, None)
    restored = _restore(cfg, meta)
    mgr = _open_writer(cfg, meta)
    every, mi = cfg.checkpoint_every, cfg.max_iterations

    sweep, assign = topk.make_topk_sweep(
        idx, damping=cfg.damping, kappa=cfg.kappa, s_mode=cfg.s_mode)
    if restored is not None:
        carry = carry_from_tree(restored, s3k.device)
    else:
        carry = dense.initial_carry(hap.hap_init(s3k), levels, n, mi)
    state, e, stable, it, trace = carry
    while not _is_done(it, stable, cfg):
        until = mi if every <= 0 else min(it + every, mi)
        carry = dense.drive_sweeps(
            state, sweep, assign, levels, n, max_iterations=mi,
            stop=cfg.stop, patience=cfg.patience, segmented=True,
            carry=carry, until=until)
        state, e, stable, it, trace = carry
        if mgr is not None:
            mgr.save(it, _carry_tree(state, e, stable, it, trace))
        faultinject.fire("solver.sweep", sweep=it, kind="single")
    return TopKState(state, idx), e, it, stable >= cfg.patience, trace


# --------------------------------------------------------- sharded segments
def _run_sharded_checkpointed(s3k: torch.Tensor, idx: torch.Tensor, mesh,
                              cfg: SolveConfig):
    levels, n, kk = s3k.shape
    run = ts.prepare_sharded(s3k, idx, mesh, exchange=cfg.exchange,
                             damping=cfg.damping, kappa=cfg.kappa,
                             s_mode=cfg.s_mode)
    ax, n_real = run.ax, run.n_real
    meta = _topk_meta("dense_topk_sharded", n, kk, cfg, ax.size,
                      run.exchange)
    # every rank reads the resumed directory before the writer may
    # rewrite its meta (when resuming into the same directory)
    restored = _restore(cfg, meta)
    barrier(ax)
    mgr = _open_writer(cfg, meta) if ax.index == 0 else None
    every, mi = cfg.checkpoint_every, cfg.max_iterations

    if restored is not None:
        carry = _repad_carry(restored, run)
    else:
        carry = dense.initial_carry(hap.hap_init(run.s_loc), levels,
                                    run.idx_loc.shape[0], mi)
    state, e, stable, it, trace = carry
    while not _is_done(it, stable, cfg):
        until = mi if every <= 0 else min(it + every, mi)
        carry = run.drive(max_iterations=mi, stop=cfg.stop,
                          patience=cfg.patience, segmented=True,
                          carry=carry, until=until)
        state, e, stable, it, trace = carry
        if every > 0:
            # the unpadded logical rows of every rank; the first rank
            # writes them while the others wait at the barrier
            logical = hap.HAPState(*(all_gather(t, ax, axis=1)[:, :n_real]
                                     for t in state))
            e_all = all_gather(e, ax, axis=1)[:, :n_real]
            if mgr is not None:
                mgr.save(it, _carry_tree(logical, e_all, stable, it, trace))
            del logical, e_all
            barrier(ax)
        faultinject.fire("solver.sweep", sweep=it, kind="sharded")
    return (TopKState(state, run.idx_loc), all_gather(e, ax, axis=1), it,
            stable >= cfg.patience, trace)


def _repad_carry(restored: dict, run: ts.ShardedSweep):
    """This rank's block of the padded carry, rebuilt from a logical
    checkpoint: real rows from disk, dummy rows at their ``hap_init``
    values (s from the padded stack, r = a = phi = c = 0, tau = +inf) and
    exemplars pointing at themselves. Dummies are inert by construction
    (self-referencing edges, a masked change counter), so the real rows
    evolve as in the uninterrupted run."""
    state, e_saved, stable, it, trace = carry_from_tree(restored,
                                                        run.s_loc.device)
    levels, b, _ = run.s_loc.shape
    lo = run.row0
    m = max(0, min(b, run.n_real - lo))          # this block's real rows

    def block(fresh, saved):
        out = fresh.clone()
        out[:, :m] = saved[:, lo:lo + m]
        return out

    own = torch.arange(lo, lo + b, dtype=torch.int32,
                       device=run.s_loc.device).expand(levels, b)
    init = hap.hap_init(run.s_loc)
    return (hap.HAPState(*(block(f, t) for f, t in zip(init, state))),
            block(own, e_saved), stable, it, trace)


# ------------------------------------------------------------ coarsen stage
def coarsen_meta(n: int, d: int, cfg: SolveConfig) -> dict:
    pref = cfg.preference if isinstance(cfg.preference, str) \
        else float(np.asarray(cfg.preference)) \
        if np.ndim(cfg.preference) == 0 else "array"
    return {
        "kind": "coarsen", "n": n, "d": d,
        "partition_size": cfg.partition_size,
        "coarsen_batch": cfg.coarsen_batch,
        "coarsen_global_dense_n": cfg.coarsen_global_dense_n,
        "coarsen_global_k": cfg.coarsen_global_k,
        "levels": cfg.levels, "max_iterations": cfg.max_iterations,
        "damping": cfg.damping, "stop": cfg.stop,
        "patience": cfg.patience, "preference": pref,
    }


def stage_path(directory: str, stage: str) -> str:
    return os.path.join(directory, stage)


def save_stage(directory: str, stage: str, tree: dict) -> None:
    save_tree(stage_path(directory, stage), tree)


def load_stage(directory: str, stage: str, like: dict):
    """Load a stage artifact, or None when it was never written."""
    path = stage_path(directory, stage)
    if not os.path.exists(os.path.join(path, "manifest.json")):
        return None
    return restore_tree(path, like)
