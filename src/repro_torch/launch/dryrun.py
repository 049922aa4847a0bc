"""Multi-pod dry run: count every (arch x shape x mesh) cell (port of
``repro/launch/dryrun.py`` by what it reports, not how).

The reference lowers and compiles each cell's step for 256 or 512 forced
host devices and mines the compiled artifact. The port runs rank 0's
program of each cell on the ``meta`` device, where nothing is computed or
allocated, against an abstract production mesh (``AbstractMesh``: axis
sizes, no ranks; its collectives move nothing and count the bytes they
would send), and counts what torch dispatches (``launch/hlo_cost.py``):

  - train cells: the mesh train step of ``train/loop.py`` (gather the
    parameters, forward and backward on the rank's data block with the
    MoE's sharded dispatch, the gradient sums, the ZeRO-1 update);
  - prefill and decode cells: the parameters gathered from their blocks,
    then the model's forward with the cache on the rank's data block (the
    whole batch where it does not split over the data axes);
  - per-device FLOPs, bytes and collective bytes; train and prefill cells
    are counted at two and three units of layers and three short sequence
    lengths and carried to the config's depth and length
    (``count_cell``), which keeps a cell to seconds;
  - the per-device bytes of the sharded state under
    ``shape_safe_shardings`` on the abstract mesh (``memory``);
  - ``params_total``/``params_active`` and ``model_flops``, exactly as the
    reference computes them;
  - the roofline terms against the H100 SXM's data-sheet rates
    (``hlo_analysis.H100_SXM``).

The reference's keys ``lower_s``, ``compile_s`` (nothing is lowered or
compiled) and ``xla_cost_flops_once`` (no XLA cost analysis) are dropped;
``count_s`` is the seconds the cell took to count, and ``memory`` holds
the state's bytes a rank (and the working copy its step gathers), not
XLA's buffer assignment.

The program counted is not the reference's. Every rank gathers the whole
parameters and repeats the dense compute of its data block on each model
rank (tensor parallelism is not ported; only the MoE's experts split), so
the per-chip FLOPs and bytes are about ``model`` times what GSPMD's
sharded program would give. Each cell says so in its ``layout`` key, and
its ``useful_ratio`` is null: the ratio of this program would not be
comparable with the reference's.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k \\
      --mesh single --out results/dryrun/granite_train_single.json
  python -m repro_torch.launch.dryrun --all --mesh both   # every cell
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import SHAPES, applicable_shapes, arch_names, get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.hlo_analysis import roofline_terms
from repro_torch.launch.hlo_cost import analyze, polynomial_fit, state_bytes
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import (
    input_specs, model_apply, model_init, model_state_init,
    model_state_specs, pick_mode,
)
from repro_torch.models.layers.common import (
    param_paths, stacked_tree, tree_get, tree_map,
)
from repro_torch.models.lm import _unit_layout
from repro_torch.sharding.partitioning import (
    Sharding, make_abstract_mesh, set_mesh, shape_safe_shardings,
)
from repro_torch.train.loop import (
    TrainState, data_axes, make_train_step, shard_train_state,
    train_state_specs,
)
from repro_torch.train.optimizer import AdamWState

META = torch.device("meta")


def param_shapes(cfg: ArchConfig):
    """-> (the model on ``meta``, its parameter tree of meta tensors in
    the reference's layout, the spec tree)."""
    model, specs = model_init(None, cfg, device=META)
    return model, stacked_tree(model, dict(model.named_parameters())), specs


def n_active_params(cfg: ArchConfig, params) -> tuple[int, int]:
    """(total, active) parameter counts of the reference-layout tree;
    MoE experts scaled by top_k / E."""
    total = active = 0

    def walk(node, path):
        nonlocal total, active
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        keypath = "/".join(path)
        n = node.numel()
        total += n
        if cfg.n_experts and "moe" in keypath and any(
                t in keypath for t in ("gate", "up", "down")):
            active += n * cfg.top_k // cfg.n_experts
        else:
            active += n

    walk(params, ())
    return total, active


def model_flops(cfg: ArchConfig, shape: ShapeConfig, active: int) -> float:
    """MODEL_FLOPS: 6*N*D train, 2*N*D inference (D = processed tokens)."""
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch      # decode: one token/seq


def _meta_scalar() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=META)


def _block_inputs(inputs: dict, mesh) -> dict:
    """The rank's rows of the inputs, or all of them where the batch does
    not split over the data axes (the shape-safe layout replicates it)."""
    axes = data_axes(mesh)
    n = math.prod(mesh.shape[a] for a in axes)
    b = inputs["tokens"].shape[0]
    if b % n:
        return inputs
    return {k: v[:b // n] for k, v in inputs.items()}


def _train_cost(cfg: ArchConfig, shape: ShapeConfig, mesh, mode):
    model, shapes, specs = param_shapes(cfg)
    state = TrainState(shapes, AdamWState(shapes, shapes, _meta_scalar()),
                       _meta_scalar())
    blocks = shard_train_state(state, _train_specs(cfg, specs), mesh)
    step = make_train_step(cfg, mode, mesh=mesh,
                           state_specs=_train_specs(cfg, specs))
    step.setup(blocks)           # the working model: not part of a step
    _, cost = analyze(step, blocks, input_specs(cfg, shape),
                      traffic=mesh.traffic)
    return cost


def _train_specs(cfg: ArchConfig, specs) -> TrainState:
    # ZeRO only where it pays (the reference's train_state_specs docstring)
    return train_state_specs(specs, zero=cfg.family not in ("ssm", "hybrid"))


def _layout(cfg: ArchConfig, shape: ShapeConfig) -> str:
    return ("list" if shape.kind == "decode" and cfg.family != "audio"
            else "stacked")


def _serve_cost(cfg: ArchConfig, shape: ShapeConfig, mesh, mode):
    model, shapes, specs = param_shapes(cfg)
    param_sh = shape_safe_shardings(mesh, shapes, specs)
    blocks = tree_map(lambda sh, x: sh.block(x), param_sh, shapes,
                      is_leaf=lambda x: isinstance(x, Sharding))
    inputs = _block_inputs(input_specs(cfg, shape), mesh)
    states = model_state_init(cfg, inputs["tokens"].shape[0], shape.seq_len,
                              layout=_layout(cfg, shape), device=META)
    paths = param_paths(model)

    def program():
        full = tree_map(lambda sh, x: sh.gather(x), param_sh, blocks,
                        is_leaf=lambda x: isinstance(x, Sharding))
        with torch.no_grad():
            for name, p in model.named_parameters():
                path, index = paths[name]
                p.copy_(tree_get(full, path)[index])
            with set_mesh(mesh):
                return model_apply(model, cfg, inputs, mode, states=states)

    _, cost = analyze(program, traffic=mesh.traffic)
    return cost


def state_nbytes(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """This rank's bytes of the cell's state: parameters and AdamW moments
    (train) or parameters and decode caches, under the shape-safe layout
    on ``mesh``; and ``working_bytes``, the whole parameters (and, to
    train, their gradients) that the port's step gathers onto every rank,
    which the state's blocks do not count."""
    model, shapes, specs = param_shapes(cfg)
    whole = sum(p.numel() * p.element_size() for p in model.parameters())
    if shape.kind == "train":
        ss = _train_specs(cfg, specs)
        return {"params_bytes": state_bytes(
                    shape_safe_shardings(mesh, shapes, ss.params), shapes),
                "opt_bytes": 2 * state_bytes(
                    shape_safe_shardings(mesh, shapes, ss.opt.mu), shapes),
                "working_bytes": 2 * whole}
    layout = _layout(cfg, shape)
    states = model_state_init(cfg, input_specs(cfg, shape)["tokens"].shape[0],
                              shape.seq_len, layout=layout, device=META)
    return {"params_bytes": state_bytes(
                shape_safe_shardings(mesh, shapes, specs), shapes),
            "cache_bytes": state_bytes(shape_safe_shardings(
                mesh, states, model_state_specs(cfg, layout=layout)),
                states),
            "working_bytes": whole}


def _cut(cfg: ArchConfig, units: int) -> ArchConfig:
    _, pat, rest = _unit_layout(cfg)
    return dataclasses.replace(cfg, n_layers=units * len(pat) + len(rest))


def sample_lengths(cfg: ArchConfig, shape: ShapeConfig) -> tuple:
    """The sequence lengths a train or prefill cell is counted at: three,
    equally spaced, past any image prefix, multiples of the attention's
    1,024-token chunks where the cell runs blockwise, so that the cost is
    one quadratic through them; for xLSTM, which has no attention, two
    multiples of the mLSTM's chunk (the cost is linear in the length)."""
    mode = pick_mode(cfg, shape.kind, shape.seq_len)
    if cfg.family == "ssm":
        # no attention: every term is linear in the length, two points
        return (cfg.mlstm_chunk, 2 * cfg.mlstm_chunk)
    step = 1024 if mode.attn_impl == "blockwise" else 16
    base = cfg.img_tokens if cfg.family == "vlm" else 0
    return tuple(base + i * step for i in (1, 2, 3))


def count_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """One rank's ``Cost`` of the cell's step, counted at two and three
    units of layers and carried to the config's depth (a config of three
    units or fewer, and whisper's encoder-decoder, is counted whole; one
    unit is no sample: a stacked leaf of one unit can be contiguous where
    more are not, which saves a copy). Where the number of ops grows with
    the sequence (a blockwise attention's chunk loops, a recurrence's time
    loop) each depth is counted at three lengths (``sample_lengths``) in
    the cell's layout and carried to its length (``polynomial_fit``)."""
    fn = _train_cost if shape.kind == "train" else _serve_cost
    mode = pick_mode(cfg, shape.kind, shape.seq_len)
    units = _unit_layout(cfg)[0] if cfg.family != "audio" else 0
    depths = (2, 3) if units > 3 else (0,)
    by_length = shape.kind != "decode" and (
        mode.attn_impl == "blockwise" or cfg.family in ("ssm", "hybrid"))

    def at_depth(u):
        c = _cut(cfg, u) if u else cfg
        if not by_length:
            return fn(c, shape, mesh, mode)
        return polynomial_fit(
            {s: fn(c, dataclasses.replace(shape, seq_len=s), mesh, mode)
             for s in sample_lengths(cfg, shape)}, shape.seq_len)

    costs = {u: at_depth(u) for u in depths}
    return polynomial_fit(costs, units) if len(costs) > 1 else costs[0]


LAYOUT = ("replicated compute: the whole parameters gathered on every "
          "rank, the dense compute repeated on each model rank (experts "
          "split over model)")


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    mesh = make_abstract_mesh(*production_mesh_shape(multi_pod))
    chips = mesh.size
    t0 = time.perf_counter()
    cost = count_cell(cfg, shape, mesh)
    nbytes = state_nbytes(cfg, shape, mesh)
    count_s = time.perf_counter() - t0
    _, params, _ = param_shapes(cfg)
    total_p, active_p = n_active_params(cfg, params)
    mflops = model_flops(cfg, shape, active_p)
    terms = roofline_terms(cost.flops, cost.bytes, cost.wire_bytes, chips)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "layout": LAYOUT, "count_s": count_s,
        "hlo_flops_per_chip": cost.flops, "hlo_bytes_per_chip": cost.bytes,
        "elementwise_per_chip": cost.elementwise,
        "collective_bytes_per_chip": cost.wire_bytes,
        "collective_ops": cost.collective_ops,
        "collective_by_type": cost.wire_by_type,
        "params_total": total_p, "params_active": active_p,
        "model_flops": mflops,
        "useful_ratio": None,
        "memory": {**nbytes, "state_bytes": nbytes["params_bytes"]
                   + nbytes.get("opt_bytes", 0)
                   + nbytes.get("cache_bytes", 0)},
        **terms,
    }


def _count(cell: tuple) -> tuple:
    """-> (label, result or None, error or None): one cell, in a worker."""
    arch, shape, multi = cell
    label = f"{arch} x {shape} x {'multi' if multi else 'single'}"
    try:
        return label, run_cell(arch, shape, multi), None
    except Exception as exc:  # noqa: BLE001 (a cell's failure is reported
        # and the other cells go on, as in the reference)
        return label, None, f"{exc}\n{traceback.format_exc()}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(name, sh.name) for name in arch_names()
                 for sh in applicable_shapes(get_arch(name))]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    jobs = [(arch, shape, multi) for arch, shape in cells for multi in meshes]
    # the recurrent families' cells first: they take longest to count
    jobs.sort(key=lambda j: get_arch(j[0]).family not in ("ssm", "hybrid"))

    t0 = time.perf_counter()
    if len(jobs) > 1:
        # cells are independent: one process for each core this process
        # may run on (the recurrent families' train cells take tens of
        # seconds each)
        ctx = multiprocessing.get_context("spawn")
        cores = len(os.sched_getaffinity(0))
        with ctx.Pool(min(len(jobs), cores)) as pool:
            outcomes = pool.map(_count, jobs, chunksize=1)
    else:
        outcomes = [_count(jobs[0])]
    results, failures = [], []
    order = {(a, s): i for i, (a, s) in enumerate(cells)}
    outcomes = [o for _, o in sorted(zip(jobs, outcomes), key=lambda jo: (
        order[jo[0][:2]], jo[0][2]))]
    for label, res, err in outcomes:
        if res is None:
            failures.append({"cell": label, "error": err})
            print(f"[FAIL] {label}: {err}", flush=True)
            continue
        results.append(res)
        print(f"[OK] {label}: count={res['count_s']:.2f}s "
              f"flops/chip={res['hlo_flops_per_chip']:.3e} "
              f"coll/chip={res['collective_bytes_per_chip']:.3e}B "
              f"dominant={res['dominant']}", flush=True)
    print(f"[dryrun] {len(results)} cells counted, {len(failures)} failed, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures}, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
