"""Solver checkpoint/resume on one device: sweep segments and per-stage
artifacts (port of ``repro/solver/checkpointing.py``).

The two long-running backends take ``SolveConfig.checkpoint_every`` /
``checkpoint_dir`` / ``resume_from``:

* **dense_topk** — the Jacobi loop runs as *segments* of
  ``dense.drive_sweeps`` (``segmented=True``); between segments the host
  snapshots the compressed message state and the loop counters through
  ``repro_torch.checkpoint``. A plain solve is one segment of the same
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

The reference's sharded runner (``sweep="sharded"``, with its re-padding
of the logical state) comes with the distributed slice (``ROADMAP.md``
queue A.7).
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
from repro_torch.solver import dense, topk
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
    """Checkpoint-aware replacement for ``topk.run_topk``, with its return
    contract ``(TopKState, exemplars, n_sweeps, converged, trace)``.

    ``mesh`` is the reference's sharded sweep, whose checkpointed runner
    is not ported yet: with a mesh it raises."""
    if mesh is not None:
        raise NotImplementedError(
            "checkpointed sharded sweeps are not ported yet (ROADMAP.md "
            "queue A.7); pass sweep='single' to checkpoint in a group")
    return _run_single_checkpointed(s3k, idx, cfg)


def _open_run(cfg: SolveConfig, meta: dict):
    """Validate/initialize the checkpoint directories; returns
    ``(manager_or_None, restored_tree_or_None)``."""
    restored = None
    if cfg.resume_from:
        check_meta(cfg.resume_from, meta)
        mgr_in = CheckpointManager(cfg.resume_from, keep=2,
                                   async_save=False)
        hit = mgr_in.restore_latest(_carry_like())
        if hit is None:
            raise ValueError(
                f"resume_from={cfg.resume_from!r} holds no step_* "
                "checkpoints to resume")
        restored = hit[1]
    mgr = None
    if cfg.checkpoint_every > 0:
        if not cfg.resume_from or \
                os.path.abspath(cfg.resume_from) != \
                os.path.abspath(cfg.checkpoint_dir):
            reset_dir(cfg.checkpoint_dir)
        write_meta(cfg.checkpoint_dir, meta)
        mgr = CheckpointManager(cfg.checkpoint_dir, keep=2,
                                async_save=False)
    return mgr, restored


def _run_single_checkpointed(s3k: torch.Tensor, idx: torch.Tensor,
                             cfg: SolveConfig):
    s3k = s3k.float().contiguous()
    levels, n, kk = s3k.shape
    meta = _topk_meta("dense_topk_single", n, kk, cfg, 1, None)
    mgr, restored = _open_run(cfg, meta)
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
