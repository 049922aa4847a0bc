#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

env       torch and CUDA versions, the card, TF32 switched off
build     nvcc builds every kernel in ``src/repro_torch/csrc`` (seconds,
          ptxas registers / shared memory / spills per kernel)
kernels   each kernel against its plain PyTorch version on the card, at the
          main path's shape (N = 10,609) and a ragged one (N = 4,099,
          d = 64), on random and on integer-valued (tie-heavy) inputs,
          and responsibility and availability also on a real HAP state
          (the Mandrill solve after 5 plain sweeps); availability bit for
          bit against the plain version summed in the kernel's order, and
          on inputs where both branches of Eq 2.2 occur off the diagonal;
          kernel, plain and bound times
median    the median-select kernel on the Mandrill's 10,609 x 10,609
          similarities and on the sampled median's 2,048 x 2,048 subsample
          of the blobs: its two order statistics equal ``torch.kthvalue``'s
          under ``==``; kernel, bound and the two ``kthvalue`` calls' times
topk      the fused top-k build (``topk_build``) against its plain versions
          on the card: the N = 200,000 blobs of ``bench_scaling.py`` (d =
          2, k = 64) bit for bit against ``in_kernel_order`` and within
          ``topk_build.compare_with_plain`` of ``plain``; the Mandrill
          pixels at 512 x 512 (N = 262,144, d = 3, k = 64) bit for bit
          against ``plain``; a ragged N = 4,099, d = 64, k = 129 case and
          N = 130, k = 129 (= N - 1), also bit for bit against the
          reference scan on the card; kernel, plain and bound times; at
          the blobs and the pixels also commit 4608d21's kernel (built
          from git, or from a copy under ``build/topk_baseline/``, into a
          temporary directory), bit for bit and timed in turns
solve     ``solve(x, backend="dense_fused")`` on the paper's Mandrill image
          at full resolution (103 x 103 pixels -> N = 10,609, d = 3; 3
          levels, 50 sweeps), fixed and converged stopping, held against
          the plain PyTorch path (``dense_parallel``) on the same card; the
          kernels' launch counts over the main-path call; auto-select on
          CUDA: the 10,609 pixels (N >= 8,192) route to ``dense_topk``,
          their first 8,000 to ``dense_fused``
solve_topk the default ``solve(x)`` on the 200,000 blobs: auto-select
          routes it to ``dense_topk`` with the fused build (k = 64, 3
          levels, 50 sweeps, sampled median preference); against
          ``build="reference"`` (the reference scan) under fixed stopping,
          identical edge sets, exemplars, counts and trace; converged
          stopping; wall time of the second call, peak memory, launch
          counts; where the time goes (build, sampled preference, sweeps)
attention ``ops.flash_attention`` (``flash_attention``) against its plain
          version on the card: the flash kernel's ptxas lines; the
          prefill of tinyllama-1.1b (32 heads, 4 KV heads broadcast,
          head_dim 64; batch 8 x 2,048 -> (256, 2,048, 64), causal) in
          bf16 and f32 and of qwen2.5-32b (40 heads, 8 KV heads, head_dim
          128; batch 2 x 4,096) and recurrentgemma-9b (16 heads, 1 KV
          head, head_dim 256; batch 8 x 2,048) in bf16, then D = 256 in
          f32 and bf16, ragged causal and non-causal S = 1,000, Sq = 192
          < Sk = 320, Sq = 600 > Sk = 300 in f32 and bf16, and a
          concentrated softmax (q x 4) in bf16; the branches each case
          reaches; one launch per call; a bit-equal re-run; the largest
          error and its share of the tolerance; kernel, plain, SDPA and
          bound times at the model shapes, with the TFLOP/s of the
          kernel's own tensor-core work (6 D a pair in bf16, 12 D in f32)
launches  the launch counts of each path's main call (``dense_fused``,
          ``dense_topk``, ``ops.flash_attention`` at the tinyllama bf16
          shape), each read around that call alone
solve_twostage ``solve(x, metric="neg_euclidean")`` on the 200,000
          blobs: auto routes it to ``dense_topk`` with the two-stage
          build; against ``build="reference"``: identical edge sets,
          exemplars, counts and trace; wall time, host syncs; then the
          two-stage and reference builds alone on the blobs and, with
          cosine, on the 512 x 512 Mandrill pixels: identical edge sets,
          build times, host syncs and their round-trip cost
solve_streaming ``solve(x, levels=1)`` on the 200,000 blobs: auto routes
          it to ``sharded_streaming``; wall time, cluster count, host reads
solve_coarsen the default ``solve(x)`` on 1,000,000 blobs
          (``bench_scaling.py``'s largest coarsen row): auto routes it to
          ``coarsen``; kd cells, local exemplars E, the global stage's
          backend, the ``topk_build`` launches around the call, and the
          decisions against the global stage built with the reference
          scan (identical)
solve_graph the 200,000 blobs' top-k graph: ``EdgeList.from_points(x,
          64)`` (the fused kernel, one launch; its edge set bit for bit the
          fused build's), ``canonical()`` and ``to_topk()`` timed on the
          host (edge counts, padded degree, layout bytes);
          ``solve(edge_list)`` -> ``graph_affinity`` (3 levels): rounds,
          host reads, wall time, clusters per level, labels, rounds and
          trace equal to the same round loop on the CPU; at 20,000 blobs
          equal to a numpy Borůvka oracle; ``graph_affinity`` from points
          (one launch); the edges natively on ``dense_topk`` (kk, state
          bytes) against the default build with the same preference; the
          default solve with ``preseed="graph"`` (one launch), and at
          20,000 blobs its fused build against ``build="reference"``
solve_distributed the MR backends and the sharded top-k path on 4 ranks
          that share the card (``sharding.dist.spawn``; gloo, every
          collective through host memory): the Mandrill similarity stack
          built on every rank (bit-equal to this process's S), then
          ``mr1d_stats`` and ``mr2d`` (2 x 2 grid) for 20 sweeps and
          ``mr1d_transpose`` for 3, against ``dense_parallel`` on the card
          at the same depth (equal cluster counts, at most 0.1 % of points
          with another exemplar); the blobs' sharded build (edge sets bit
          for bit the fused build's), the default ``solve(x)`` in the
          group at 3 sweeps (routed to ``dense_topk`` with the sharded
          build and sweep; decisions and trace equal to the one-process
          default solve at 3 sweeps), and the sharded sweeps with the
          allgather exchange under the converged stop (6 sweeps) and the
          psum exchange under the fixed one (30) (decisions and traces
          equal to ``run_topk``'s on the fused lists); each of the two
          checkpointed (every 3 and every 10 sweeps), crashed after the
          second save and resumed (decisions, trace, sweep count, flag and
          every rank's state block bit-equal to the plain sharded run; ms a
          save, gather and write apart, bytes a step, ms a resume); the
          sharded Borůvka on solve_graph's layout of the blobs (labels,
          rounds and trace equal to the one-process loop on the card);
          ``solve(edge_list)`` at 20,000 blobs, by default and with
          ``sweep="sharded"`` (the route, whether the mesh was used,
          decisions equal to one process); MapReduce K-means on the blobs
          (labels equal to one-process ``kmeans`` on the card, centers and
          inertia within 1e-5); each rank's walls, bytes sent and launches
          (``similarity`` on every rank's builds: the blobs' top-k lists
          and the 20,000-blob edge list, both sharded), bytes a sweep beside
          ``comm_bytes_per_iteration``/``comm_bytes_per_sweep``; and
          ``python -m repro_torch.launch.cluster --workers 4``
baselines the paper's comparison baselines and the two HAP hooks on the card:
          K-means on the 200,000 blobs (k = 16, 25 steps, the seed-0
          draw; time, purity, labels against the CPU port's: at most 0.1 %
          apart); HK-Means on them (3 levels, branch 3: canopy on the host
          and K-means on the card timed apart, clusters and purity a level,
          the levels nest, the top level K-means from the canopy seeds);
          ``benchmarks/bench_purity.py``'s Fig 5.1 comparison
          (aggregation, 600 blobs, 400 moons; L = 3, 40 sweeps, damping
          0.7, median preference; ``dense_parallel``, ``dense_topk`` k = 32
          and HK-Means: purity and clusters a level on the card and the
          CPU, decisions and HK-Means' top level equal); ``hap_curate_batch``
          on 4,096 embeddings of width 1,024 (512 bases x 8 near-copies;
          kept indices equal to the CPU's at base scale 0.25; at 1.0,
          ROADMAP C9, one kept copy of every base on the card and on the
          CPU, and how many bases the two kept by another copy); ``cluster_experts`` at 128
          experts over 4,096 tokens of planted co-activated pairs (clusters
          equal to the CPU's, every pair in one cluster)
solve_checkpoint the default ``dense_topk`` solve of the blobs under both
          stops, run plain, checkpointed every 10 sweeps, crashed at the
          second save and resumed, and resumed from a copy of the crashed
          directory: state, decisions and trace bit-equal across the four;
          wall times, ms per save, bytes per step, ms per resume; then
          ``solve`` on the 1,000,000 blobs (coarsen) crashed mid-local and
          after the global save, each resumed to the uninterrupted
          ``solve_coarsen`` decisions; ``topk_build``'s launches on every
          path that builds, each read around its own run
serve     the clustering service (``repro_torch.serve.cluster``) on the
          card: ``bench_serve.py``'s FULL load sweep (buckets 128, 256,
          512 x 2, batch 8, 2 levels, <= 100 sweeps; 40 Poisson requests,
          not its 120, at 5, 20, 50 and 100 rps, half on one stream):
          offered and
          achieved rps, p50/p95/p99, the first request's latency, micro-
          batches, riders a batch, fast-path share, no cache miss after
          warmup, no kernel launch on the batched path; where a batch's
          time goes (padding, the batched launch, finishing) and the fast
          path's assignment on the host against the card; the ceiling
          bucket (4,096, 2, 8): ms a launch, peak memory; 16 requests on
          the card against the same service on the CPU (decisions, and
          how far the traces drift); overflow of 20,000 blobs to
          ``dense_topk`` and of 250,000 to ``coarsen``, one ``topk_build``
          launch each, decisions equal to the direct solves;
          ``bench_serve.py``'s CHAOS_FULL (4 workers on the card, 3 kills
          at ``serve.launch``): every future resolves; and
          ``python -m repro_torch.launch.cluster_serve --smoke``
lm_serve  the LM serving path (``repro_torch.serve``, no kernel of its
          own): (a) tinyllama-1.1b at full width and depth (22 layers,
          d_model 2,048; random parameters from a generator seeded 0) served
          by ``ServeEngine.generate`` on 8 prompts of 512 tokens, 64 greedy
          steps: prefill ms, decode ms a step, tokens/s, peak memory;
          finite logits, a second call's tokens equal, and on 2 rows the
          decode logits at the last position against the full forward's:
          within 1e-4 in float32 compute, and in bfloat16 within 2e-2
          (atol = rtol) or ``LM_DECODE_BF16_BAR``, 1.5 x the reference's
          own gap at this depth and length on the CPU (it misses 2e-2
          there too: ``tools/lm_decode_drift.py --seq 512``); (d)
          ``exemplar_compress_cache`` on layer 0's cache of that prefill
          (window 512, the median preference) on the card and the CPU:
          kept counts and masks equal; (b) ``ContinuousBatchingEngine``,
          8 slots, 16 requests of 32-512 prompt tokens and 16-64 steps:
          each output equal to its isolated ``generate``; (c) the card
          against the CPU, same parameters and inputs: the ten ``-smoke``
          configs (forward, prefill, one decode step; MoE routing decisions
          equal) and tinyllama cut to 2 layers (16-token prompt, 4 steps),
          logits within 1e-4 with both in float32 compute, and as
          configured within max(2e-2, 1.5 x the CPU's own bfloat16 error
          against its float32 run), greedy tokens equal where the CPU's
          top-2 margin exceeds twice that; (e) ``python -m
          repro_torch.launch.serve --arch tinyllama-1.1b --steps 16``; the
          five kernels' launches over the phase (0)
lm_train  LM training (``repro_torch.train``, no kernel of its own): (a)
          tinyllama-1.1b at full width and depth (random parameters from a
          generator seeded 0) trained by ``make_train_step`` (AdamW, the
          warmup-cosine schedule at ``launch/train.py``'s defaults, each
          layer recomputed in backward) for 12 steps of 8 x 512 tokens of
          ``synthetic_token_stream(seed=0)``: ms a step (host clock around
          each synchronised step, steps 2-12), tokens/s, peak memory;
          loss, ce and the gradients finite at every step, the mean ce of
          the last 5 steps below the first step's, and step 1 run twice
          from the same state (loss and moments within 1e-4; what differs
          is reported); (b) at full width cut to 2 layers, on the first
          batch: ``microbatches=2`` against 1 (ce within 1e-4 and
          parameters within 1e-5 at ``tests/test_train.py``'s schedule,
          moments within 1e-4 in float32 compute) and top-k compression at
          ratio 0.01 (each compressed leaf of ``opt.mu`` keeps its top
          share, more only by ties); (c) one train step on the card
          against the CPU on the ten ``-smoke`` configs and on tinyllama
          cut to 2 layers (2 x 128 tokens): loss, ce, aux and the moments
          within 1e-4 with both in float32 compute, within max(2e-2, 1.5 x
          the CPU's own bfloat16 error) as configured, MoE routing equal;
          (d) ``python -m repro_torch.launch.train --arch tinyllama-1.1b
          --steps 5`` at full width, and on the ``-smoke`` config a run of
          10 steps checkpointing every 5 and a second of 15 on the same
          directory, which must restore step 10; the five kernels'
          launches over the phase (0)
lm_elastic  elastic resharding and sharded training (no kernel of its
          own), 4 ranks sharing the card over gloo: (a) qwen3-moe-235b-a22b's
          MoE layer at full width (d_model 4,096, 128 experts, d_ff 1,536,
          top-8; 2.42 B parameters from a generator seeded 23) on 4 x 512
          tokens, first in one process (forward and backward at
          ``capacity_factor=8.0``, float32, TF32 off), then on a 2 x 2
          (data, model) mesh, expert-parallel, each rank drawing the layer
          and keeping its 64 experts: routing equal, and y, aux, the x and
          router gradients and the expert gradients (a linear probe of
          every expert's, and the first and last expert of each rank
          whole; the data ranks' mean) each within 2e-5 of its own max
          |value| (the scales printed beside the errors);
          the choices dropped at 1.25 by both; (b) tinyllama-1.1b at full
          width cut to 2 layers trained 4 steps of 8 x 512 on 2 x 2, saved
          (the blocks gathered, rank 0 writing), 4 steps more; then
          restored onto 1 x 2 (half the ranks lost) for the same 4 steps:
          losses within 1e-3 of the uninterrupted run; ms a step, bytes
          sent, peak memory a rank, save and restore ms; (c) beside them,
          on three eighths of the host's cores, ``python -m
          repro_torch.launch.dryrun --all --mesh both`` (64 cells, exit 0);
          the five kernels' launches over the phase (0)
profile   only with ``--profile``: ``torch.profiler`` traces of a 10-sweep
          ``dense_fused`` solve, a 10-sweep ``dense_topk`` solve, the
          two-stage build of the 200,000 blobs (neg_euclidean) and one
          full-width tinyllama-1.1b train step (8 x 512; also with
          ``--only lm_train``), device time by kernel, device events and
          the device's idle share

After each phase a line ``{"phase": "clock", "after": ..., "t_s": ...}``
gives the seconds since the script's start. Then the card's name and
power limit as nvidia-smi prints them, the
kernels line ``{"kernels": [...]}`` (``lm_serve_launches``,
``lm_train_launches`` and ``lm_elastic_launches``: each kernel's launches
over the three LM phases), and last ``{"ok": true, "device": {...}}``.
``--only lm_serve``, ``lm_train`` or ``lm_elastic`` runs the env phase
and that phase alone and stops without the last line. Any failed check exits
non-zero with the traceback and without the last line; so does a machine
without a CUDA device, or a directory without the repository's ``src/``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import obs  # noqa: E402

N_MAIN = 10_609          # 103 x 103 pixels
N_RAGGED, D_RAGGED = 4_099, 64
N_BLOBS = 200_000        # benchmarks/bench_scaling.py's largest row
K_TOPK = 64              # SolveConfig().k resolves to it (DEFAULT_K)
LAM = 0.7                # SolveConfig().damping
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
FP32_OPS_PER_S = 67e12       # H100 SXM FP32 outside the tensor cores
BF16_OPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12      # H100 SXM TF32 tensor cores, dense
# f32-accurate products on the tensor cores: three TF32 products each
# (3xTF32), so a third of the TF32 rate; the flash kernel's f32 bound
F32_SPLIT_OPS_PER_S = TF32_OPS_PER_S / 3
MAX_MISMATCH = 1e-3      # share of points whose exemplar may differ
DEVICE = "cuda"


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def host_copies(site: str) -> int:
    """The counter ``host_copies.<site>`` of ``repro_torch.obs``: the
    site's reads since its last reset."""
    return obs.counters().get("host_copies." + site, 0)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ kernels
HAP_SWEEPS = 5           # sweeps before the state the "hap" cases take
HAP_LEVEL = 1            # middle level: finite tau, non-zero c and phi
MIN_BRANCH_SHARE = 0.01  # off-diagonal share each branch of Eq 2.2 needs
MAX_TOL_SHARE = 1e-3     # median tolerance / median |output|, at most


def hap_operands(x) -> dict:
    """The operands the responsibility and availability kernels take at
    level HAP_LEVEL in sweep HAP_SWEEPS + 1 of a plain default solve of
    ``x``: a real HAP state, whose column sums are small enough that both
    branches of Eq 2.2 occur off the diagonal."""
    from repro_torch.core import hap
    from repro_torch.core.preferences import median_preference
    from repro_torch.core.similarity import set_preferences, stack_levels
    from repro_torch.kernels import similarity
    from repro_torch.solver.dense import run_dense

    s = similarity.plain(x, x)
    s3 = stack_levels(set_preferences(s, median_preference(s)), 3)
    state = run_dense(s3, order="parallel", max_iterations=HAP_SWEEPS,
                      damping=LAM)[0]
    taken = {}

    def update_r(s, a, tau, r):
        taken["responsibility"] = tuple(
            t[HAP_LEVEL].clone() for t in (s, a, tau, r))
        return LAM * r + (1.0 - LAM) * hap.rho_update(s, a, tau)

    def update_a(r, c, phi, a):
        taken["availability"] = tuple(
            t[HAP_LEVEL].clone() for t in (r, c, phi, a))
        return a

    hap.jacobi_sweep(state, False, lam=LAM, kappa=0.0, s_mode="off",
                     update_r=update_r, update_a=update_a)
    return taken


def kernel_cases(x_pixels) -> list[dict]:
    """Each case: the kernel's wrapper call, its plain version, the
    version it must equal bit for bit (or None), the elementwise tolerance
    against the plain version (None: bit-identical), bytes and operations.
    """
    from repro_torch.kernels import availability, responsibility, similarity
    from repro_torch.solver import SolveConfig

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev).float()

    cases = []
    for n, d in ((N_MAIN, 3), (N_RAGGED, D_RAGGED)):
        ints = (x_pixels if n == N_MAIN else randint(0, 256, n, d))
        for kind, x in (("integer", ints), ("random", randn(n, d))):
            exact = kind == "integer"   # partial sums < 2**24: exact
            cases.append(dict(
                name="similarity", case=f"n={n},d={d},{kind}",
                kernel=lambda x=x: similarity.neg_sqeuclidean(x, x),
                plain=lambda x=x: similarity.plain(x, x),
                exact=(lambda x=x: similarity.plain(x, x)) if exact else None,
                tol=None if exact else
                (lambda want, x=x: similarity.tolerance(x, x)),
                nbytes=4 * (2 * n * d + n * n), ops=n * n * (2 * d + 4)))
    # the tile each rank of the sharded top-k build hands the kernel: a
    # block of build_block_rows rows against build_block_cols columns of
    # 2-D points (solve_distributed's blobs)
    tr, tc = SolveConfig().build_block_rows, SolveConfig().build_block_cols
    for kind, (x, y) in (("integer", (randint(0, 256, tr, 2),
                                      randint(0, 256, tc, 2))),
                         ("random", (4 * randn(tr, 2), 4 * randn(tc, 2)))):
        exact = kind == "integer"
        cases.append(dict(
            name="similarity", case=f"tile {tr}x{tc},d=2,{kind}",
            kernel=lambda x=x, y=y: similarity.neg_sqeuclidean(x, y),
            plain=lambda x=x, y=y: similarity.plain(x, y),
            exact=(lambda x=x, y=y: similarity.plain(x, y)) if exact
            else None,
            tol=None if exact else
            (lambda want, x=x, y=y: similarity.tolerance(x, y)),
            nbytes=4 * (2 * (tr + tc) + tr * tc), ops=tr * tc * (2 * 2 + 4)))
    for n in (N_MAIN, N_RAGGED):
        hap = hap_operands(x_pixels[:n])
        for kind in ("random", "ties", "hap"):
            if kind == "hap":
                s, a, tau, r_old = hap["responsibility"]
            elif kind == "ties":   # integer-valued: duplicated row maxima
                s, a = -randint(0, 4, n, n), randint(-2, 3, n, n)
                r_old, tau = randn(n, n), randn(n)
            else:
                s, a = -10 * torch.rand(n, n, generator=g, device=dev), \
                    randn(n, n)
                r_old, tau = randn(n, n), randn(n)
            args = (s, a, tau, r_old, LAM)
            cases.append(dict(
                name="responsibility", case=f"n={n},{kind}",
                kernel=lambda args=args: responsibility.responsibility(*args),
                plain=lambda args=args: responsibility.plain(*args),
                exact=lambda args=args: responsibility.plain(*args),
                tol=None, nbytes=4 * (4 * n * n + n), ops=8 * n * n))
        for kind in ("random", "ties", "hap"):
            if kind == "hap":
                r, c, phi, a_old = hap["availability"]
            elif kind == "ties":
                # integers, so every partial sum is exact: mostly negative,
                # about 4 positive entries per column, so col_j is O(10)
                r = torch.where(
                    torch.rand(n, n, generator=g, device=dev) < 4.0 / n,
                    randint(1, 4, n, n), randint(-8, 1, n, n))
                c, phi, a_old = randint(-6, 2, n), randint(-6, 2, n), \
                    randint(-3, 4, n, n)
            else:
                # mostly negative, as responsibilities are: col_j is O(1)
                r = randn(n, n) - 3.0
                c, phi, a_old = randn(n), randn(n), randn(n, n)
            args = (r, c, phi, a_old, LAM)
            cases.append(dict(
                name="availability", case=f"n={n},{kind}",
                kernel=lambda args=args: availability.availability(*args),
                plain=lambda args=args: availability.plain(*args),
                exact=lambda args=args: availability.in_kernel_order(*args),
                tol=None if kind == "ties" else
                (lambda want, args=args: availability.tolerance(
                    *args[:3], LAM, want)),
                branches=lambda args=args: eq22_branch_shares(*args[:3]),
                nbytes=4 * (3 * n * n + 2 * n), ops=7 * n * n))
        del hap
    return cases


def eq22_branch_shares(r, c, phi) -> dict:
    """Shares of the off-diagonal entries where Eq 2.2's min(0, .) takes
    the sum (negative) and where it takes 0."""
    from repro_torch.kernels import availability
    fresh = availability.plain(r, c, phi, torch.zeros_like(r), 0.0)
    off = ~torch.eye(r.shape[0], dtype=torch.bool, device=r.device)
    n_off = float(off.sum())
    return {"negative": float(((fresh < 0) & off).sum()) / n_off,
            "zero": float(((fresh == 0) & off).sum()) / n_off}


def sampled_median(t: torch.Tensor) -> float:
    return float(t.flatten()[::101].median())


def check_case(cs: dict) -> tuple[dict, float]:
    """Run one kernel case and check it; returns its line and error."""
    name, case = cs["name"], cs["case"]
    got = cs["kernel"]()
    again = cs["kernel"]()
    want = cs["plain"]()
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{name} {case}: re-run differs")
    err = float((got - want).abs().max())
    line = {"phase": "kernels", "kernel": name, "case": case,
            "max_abs_err": err}
    if cs["exact"] is not None:
        check(torch.equal(got, cs["exact"]()),
              f"{name} {case}: differs from its exact version")
        line["bit_identical_to"] = ("plain" if name != "availability"
                                    else "in_kernel_order")
    if cs["tol"] is None:
        line["tolerance"] = "0 (bit-identical to plain)"
        check(torch.equal(got, want),
              f"{name} {case}: not bit-identical, max err {err}")
    else:
        tol = cs["tol"](want)
        share = sampled_median(tol) / sampled_median(want.abs())
        line["tolerance"] = (f"<= {name}.tolerance elementwise "
                             f"(largest {float(tol.max()):.3g}, median "
                             f"{share:.3g} of the median |output|)")
        check(bool(((got - want).abs() <= tol).all()),
              f"{name} {case}: error {err} beyond tolerance")
        check(share <= MAX_TOL_SHARE,
              f"{name} {case}: tolerance {share:.3g} of a typical output "
              "is too loose to fail a wrong kernel")
    if "branches" in cs:
        shares = cs["branches"]()
        line["eq22_off_diagonal"] = shares
        check(min(shares.values()) >= MIN_BRANCH_SHARE,
              f"{name} {case}: inputs leave a branch of Eq 2.2 untested: "
              f"{shares}")
    return line, err


def run_kernels(x_pixels) -> dict:
    summary = {name: {"max_abs_err": 0.0}
               for name in ("similarity", "responsibility", "availability")}
    for cs in kernel_cases(x_pixels):
        name = cs["name"]
        line, err = check_case(cs)
        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], err)
        if cs["case"].startswith(f"n={N_MAIN},") and "plain_ms" not in \
                summary[name]:
            k_ms = cuda_ms(cs["kernel"], iters=20)
            p_ms = cuda_ms(cs["plain"], iters=5, warmup=1)
            b_ms, b_by = bound_ms(cs["nbytes"], cs["ops"])
            summary[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None)
            line.update(kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None,
                        library="none" if name != "similarity" else
                        "none: torch.cdist gives the distance's root, so "
                        "-cdist(x, y)**2 takes two calls")
        emit(line)
    return summary


# ------------------------------------------------------------ median select
def run_median_select(x_pixels, blobs) -> dict:
    """The median-select kernel at the shapes the main paths give it: the
    Mandrill's off-diagonal similarities (the dense median) and the
    similarities of the 2,048 blobs the default top-k solve subsamples
    (the sampled median). The two ``kthvalue`` calls are its plain version
    and the library's selection alike."""
    from repro_torch.core import pairwise_similarity
    from repro_torch.kernels import median_select, ref
    from repro_torch.solver import topk

    sel = torch.randperm(blobs.shape[0], generator=topk.sample_generator(0))
    sub = torch.from_numpy(blobs)[sel[:topk.PREF_SAMPLE]].to(DEVICE)
    out = {}
    for label, s in (("mandrill", pairwise_similarity(x_pixels)),
                     ("blobs_subsample", pairwise_similarity(sub))):
        n = s.shape[0]
        got = median_select.middle_pair(s, skip_diagonal=True)
        want = ref.middle_pair(s, skip_diagonal=True)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        k_ms = cuda_ms(lambda: median_select.middle_pair(
            s, skip_diagonal=True), iters=20)
        p_ms = cuda_ms(lambda: ref.middle_pair(s, skip_diagonal=True),
                       iters=3, warmup=1)
        b_ms, b_by = bound_ms(4.0 * (n * n - n), 0.0)
        line = {"phase": "median", "case": label, "n": n,
                "lo_hi_mean": got.tolist(), "equal_kthvalue": equal,
                "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": p_ms,
                "library": "two torch.kthvalue calls", "bound_ms": b_ms,
                "bound_by": b_by}
        emit(line)
        check(equal, f"median_select {label}: {got.tolist()} against "
              f"kthvalue's {want.tolist()}")
        out[label] = line
    m = out["mandrill"]
    return {"ms": m["kernel_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "subsample_ms": out["blobs_subsample"]["kernel_ms"],
            "subsample_library_ms": out["blobs_subsample"]["library_ms"]}


# -------------------------------------------------------------------- solve
def run_solve(x) -> dict:
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solver import solve

    n = x.shape[0]
    launches = None
    for stop in ("fixed", "converged"):
        res = {}
        for backend in ("dense_fused", "dense_parallel"):
            solve(x, backend=backend, stop=stop, device=DEVICE)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            r = solve(x, backend=backend, stop=stop, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            res[backend] = r
            emit({"phase": "solve", "backend": backend, "stop": stop,
                  "n": n, "levels": r.levels, "wall_s": wall,
                  "n_sweeps": r.n_sweeps, "converged": r.converged,
                  "n_clusters": r.n_clusters.tolist(),
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "launches": counts})
            check(r.exemplars.shape == (r.levels, n)
                  and r.exemplars.min() >= 0 and r.exemplars.max() < n,
                  f"{backend} {stop}: exemplars out of range")
            if backend == "dense_fused":
                sweeps = r.levels * r.n_sweeps
                check(counts == {"similarity": 1, "responsibility": sweeps,
                                 "availability": sweeps, "topk_build": 0,
                                 "flash_attention": 0, "median_select": 1},
                      f"dense_fused {stop}: launches {counts}, expected "
                      f"similarity 1, {sweeps} per update and one median")
                if stop == "fixed":
                    launches = counts        # the main path's run
            else:
                # the median preference is the one kernel both routes share
                check(counts == {**dict.fromkeys(counts, 0),
                                 "median_select": 1},
                      f"dense_parallel launched kernels: {counts}")
        f, p = res["dense_fused"], res["dense_parallel"]
        mismatch = float((f.exemplars != p.exemplars).mean())
        emit({"phase": "solve", "compare": stop,
              "exemplar_mismatch": mismatch,
              "n_clusters_equal": bool((f.n_clusters
                                        == p.n_clusters).all()),
              "trace_equal": bool(np.array_equal(f.trace, p.trace))})
        check((f.n_clusters == p.n_clusters).all(),
              f"{stop}: cluster counts differ {f.n_clusters} "
              f"vs {p.n_clusters}")
        check(mismatch <= MAX_MISMATCH,
              f"{stop}: {mismatch:.2%} of exemplars differ")
        check(np.array_equal(f.trace, p.trace)
              and f.n_sweeps == p.n_sweeps and f.converged == p.converged,
              f"{stop}: traces differ")

    for n_auto, want in ((n, "dense_topk"), (8000, "dense_fused")):
        auto = solve(x[:n_auto], device=DEVICE)
        emit({"phase": "solve", "auto_select_n": n_auto,
              "backend": auto.backend})
        check(auto.backend == want,
              f"auto-select on CUDA chose {auto.backend} at N = {n_auto}, "
              f"expected {want}")
    return launches


# --------------------------------------------------------------- top-k
def timed(fn):
    """``fn()`` once, and its device time in ms (CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


BASELINE_COMMIT = "4608d21"   # the first top-k kernel's last commit
BASELINE_SRC = "src/repro_torch/csrc/topk_build.cu"


def baseline_topk():
    """The top-k kernel of commit BASELINE_COMMIT, built by nvcc into a
    temporary directory outside the checkout, as a function of (x, k) that
    returns its (vals, idx) in the kernel's row order; None (with the
    reason) when neither git nor a copy of that source under
    ``build/topk_baseline/`` is at hand."""
    import ctypes
    import tempfile

    from repro_torch.kernels import _build
    from repro_torch.kernels.topk_similarity import _by_column

    git = subprocess.run(["git", "show", f"{BASELINE_COMMIT}:{BASELINE_SRC}"],
                         cwd=ROOT, capture_output=True, text=True)
    copy = ROOT / "build" / "topk_baseline" / "topk_build.cu"
    if git.returncode == 0:
        src_text, origin = git.stdout, f"git show {BASELINE_COMMIT}"
    elif copy.is_file():
        src_text, origin = copy.read_text(), str(copy.relative_to(ROOT))
    else:
        return None, "no git history and no build/topk_baseline copy"
    tmp = Path(tempfile.mkdtemp(prefix="topk_baseline_"))
    (tmp / "topk_build.cu").write_text(src_text)
    lib_path = tmp / "libbaseline.so"
    out = subprocess.run(
        [_build.nvcc(), *_build.COMPILE_FLAGS, "-I", str(_build.CSRC),
         "-shared", "-o", str(lib_path), str(tmp / "topk_build.cu")],
        capture_output=True, text=True)
    check(out.returncode == 0, f"baseline top-k build failed: {out.stderr}")
    fn = ctypes.CDLL(str(lib_path)).repro_topk_build
    fn.argtypes = _build._SIGNATURES["repro_topk_build"][0]
    fn.restype = ctypes.c_int

    def run(x, k):
        n, d = x.shape
        vals = torch.empty((n, k), dtype=torch.float32, device=x.device)
        idx = torch.empty((n, k), dtype=torch.int32, device=x.device)
        norms = torch.empty(n, dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), norms.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), n, d, k,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"baseline top-k launch failed: {err}")
        return _by_column(vals, idx)

    return run, origin


def run_topk_kernel(blobs, pixels) -> dict:
    """The fused top-k build against its plain versions; returns the
    summary of the main case (the blobs)."""
    from repro_torch.kernels import topk_build
    from repro_torch.kernels.topk_similarity import topk_similarity

    g = np.random.default_rng(1)
    small = g.integers(0, 3, (130, 3)).astype(np.float32)
    small[40:60] = small[0:20]                       # duplicate points
    cases = [
        ("blobs", blobs, K_TOPK, "in_kernel_order"),
        ("pixels_512", pixels, K_TOPK, "plain"),
        ("ragged", g.standard_normal((N_RAGGED, D_RAGGED)).astype(
            np.float32), 129, "in_kernel_order"),
        ("n130", small, 129, "plain"),
    ]
    base, origin = baseline_topk()
    emit({"phase": "topk", "baseline": f"commit {BASELINE_COMMIT}'s kernel",
          "baseline_source": origin, "timed": base is not None})
    summary = {"max_abs_err": 0.0}
    for name, pts, k, exact in cases:
        x = torch.from_numpy(pts).to(DEVICE)
        n, d = x.shape
        (vals, idx), k_ms = timed(lambda: topk_build.topk_similarity_fused(
            x, k))
        again = topk_build.topk_similarity_fused(x, k)
        check(torch.equal(vals, again[0]) and torch.equal(idx, again[1]),
              f"topk_build {name}: re-run differs")
        (pv, pi), p_ms = timed(lambda: topk_build.plain(x, k))
        cmp = topk_build.compare_with_plain(x, k, vals, idx)
        want = (pv, pi) if exact == "plain" else \
            topk_build.in_kernel_order(x, k)
        check(torch.equal(vals, want[0]) and torch.equal(idx, want[1]),
              f"topk_build {name}: not bit-identical to {exact}")
        line = {"phase": "topk", "kernel": "topk_build", "case": name,
                "n": n, "d": d, "k": k, "bit_identical_to": [exact],
                **cmp}
        if n <= N_RAGGED:
            ref = topk_similarity(x, k)
            check(torch.equal(vals, ref[0]) and torch.equal(idx, ref[1]),
                  f"topk_build {name}: differs from the reference scan")
            line["bit_identical_to"].append("reference scan")
        if exact == "plain":
            check(cmp["bit_identical"],
                  f"topk_build {name}: not bit-identical to plain")
            line["tolerance"] = "0 (bit-identical to plain)"
        else:
            check(cmp["values_within_tolerance"]
                  and cmp["idx_equal_off_ties"],
                  f"topk_build {name}: beyond tolerance of plain: {cmp}")
            tol = topk_build.tolerance(x, idx)
            line["tolerance"] = (
                "topk_build.compare_with_plain (largest "
                f"{float(tol.max()):.3g}; median tolerance / median |value| "
                f"{sampled_median(tol) / sampled_median(vals.abs()):.3g})")
        nbytes = 4 * n * d + 8 * n * k            # points in, (n, k) out
        # per pair: d products and d sums of the dot, xx + yy, 2 acc, the
        # subtraction, the max and the gate's compare; per point: its norm
        b_ms, b_by = bound_ms(nbytes, float(n) * n * (2 * d + 5)
                              + 2.0 * n * d)
        line.update(kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None,
                    library="none: no one PyTorch call builds a top-k "
                    "similarity list without the (N, N) matrix")
        summary["max_abs_err"] = max(summary["max_abs_err"],
                                     cmp["max_abs_err"])
        if name in ("blobs", "pixels_512"):
            # the kernel and the baseline in turns: new, old, old, new
            def new():
                return topk_build.topk_similarity_fused(x, k)
            k_ms = [cuda_ms(new, iters=3, warmup=0)]
            if base is not None:
                old = base(x, k)
                check(torch.equal(old[0], vals) and torch.equal(old[1], idx),
                      f"topk_build {name}: differs from the baseline kernel")
                line["baseline_ms"] = [cuda_ms(lambda: base(x, k), iters=3,
                                               warmup=1) for _ in range(2)]
                line["bit_identical_to"].append("baseline kernel")
            k_ms.append(cuda_ms(new, iters=3, warmup=0))
            line["kernel_ms"] = sum(k_ms) / len(k_ms)
            line["kernel_ms_runs"] = k_ms
        if name == "blobs":
            summary.update(ms=line["kernel_ms"], plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)
        emit(line)
        del x, vals, idx, pv, pi, want, again
    return summary


def run_solve_topk(blobs):
    """The default solve on the 200,000 blobs; returns its launch counts
    and its result."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solver import SolveConfig, solve
    from repro_torch.solver.topk_build import resolve_build_backend

    n = blobs.shape[0]
    build = resolve_build_backend("auto", n=n, k=K_TOPK, platform="cuda")
    check(build == "fused", f"build resolves to {build} on CUDA")
    first = solve(blobs, device=DEVICE, keep_state=True)       # warm-up
    check(first.backend == "dense_topk",
          f"auto-select on {n} points chose {first.backend}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(blobs, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    emit({"phase": "solve_topk", "backend": res.backend, "build": build,
          "stop": "fixed", "n": n, "k": K_TOPK, "levels": res.levels,
          "wall_s": wall, "n_sweeps": res.n_sweeps,
          "n_clusters": res.n_clusters.tolist(),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches})
    check(launches == {"similarity": 0, "responsibility": 0,
                       "availability": 0, "topk_build": 1,
                       "flash_attention": 0, "median_select": 1},
          f"dense_topk launches {launches}")
    check(res.exemplars.shape == (res.levels, n)
          and res.exemplars.min() >= 0 and res.exemplars.max() < n,
          "dense_topk: exemplars out of range")
    check(np.array_equal(res.exemplars, first.exemplars)
          and np.array_equal(res.trace, first.trace),
          "dense_topk: a second solve gave other decisions")

    t0 = time.perf_counter()
    ref = solve(blobs, device=DEVICE, build="reference", keep_state=True)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    same_edges = (torch.equal(first.state.idx, ref.state.idx)
                  and torch.equal(first.state.hap.s, ref.state.hap.s))
    emit({"phase": "solve_topk", "compare": "fused vs reference build",
          "reference_wall_s": ref_wall, "edge_sets_equal": same_edges,
          "exemplars_equal": bool(np.array_equal(first.exemplars,
                                                 ref.exemplars)),
          "n_clusters_equal": bool(np.array_equal(first.n_clusters,
                                                  ref.n_clusters)),
          "trace_equal": bool(np.array_equal(first.trace, ref.trace))})
    check(same_edges, "fused and reference builds stored other edges")
    check(np.array_equal(first.exemplars, ref.exemplars)
          and np.array_equal(first.n_clusters, ref.n_clusters)
          and np.array_equal(first.trace, ref.trace)
          and first.n_sweeps == ref.n_sweeps,
          "fused and reference builds gave other decisions")
    del first, ref

    t0 = time.perf_counter()
    conv = solve(blobs, device=DEVICE, stop="converged")
    torch.cuda.synchronize()
    emit({"phase": "solve_topk", "stop": "converged",
          "wall_s": time.perf_counter() - t0, "n_sweeps": conv.n_sweeps,
          "converged": conv.converged,
          "n_clusters": conv.n_clusters.tolist()})
    check(conv.n_sweeps <= SolveConfig().max_iterations
          and conv.exemplars.shape == (conv.levels, n),
          "dense_topk converged: bad result")
    emit(topk_breakdown(blobs))
    return launches, res


def topk_breakdown(blobs) -> dict:
    """Device time of the default dense_topk solve's parts, each timed
    alone with CUDA events: the fused build, the sampled preference, the
    50 sweeps (fixed stopping keeps the change counts on the device and
    reads them once at the end; converged stopping reads one per sweep)."""
    from repro_torch.kernels.topk_build import topk_similarity_fused
    from repro_torch.solver import SolveConfig, topk

    cfg = SolveConfig()
    x = torch.from_numpy(blobs).to(DEVICE)
    (vals, idx), build_ms = timed(lambda: topk_similarity_fused(x, K_TOPK))
    pref, pref_ms = timed(lambda: topk.sampled_preferences(
        x, "median", cfg.metric, topk.sample_generator(cfg.seed)))
    s_rows, idx_full = topk._with_self_slot(vals, idx, pref)
    s3k = s_rows.expand(cfg.levels, *s_rows.shape).contiguous()
    _, sweeps_ms = timed(lambda: topk.run_topk(
        s3k, idx_full, max_iterations=cfg.max_iterations,
        damping=cfg.damping))
    return {"phase": "solve_topk", "breakdown_ms": {
        "build": build_ms, "sampled_preference": pref_ms,
        "sweeps_50": sweeps_ms, "host_syncs": "1 (fixed); 1 per sweep "
        "(converged)"}}


# ------------------------------------------------ streaming and coarsen
N_COARSEN = 1_000_000    # benchmarks/bench_scaling.py's largest coarsen row


def run_solve_streaming(blobs) -> None:
    """``solve(x, levels=1)`` on the 200,000 blobs: auto routes it to
    ``sharded_streaming`` (512-point shards, no kernel); wall time, cluster
    count and the host reads it makes (one per shard, one for the exemplar
    tier, one for the final assignment)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solver import SolveConfig, solve

    n, shard = blobs.shape[0], SolveConfig().shard_size
    obs.reset_counters("host_copies.streaming")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(blobs, levels=1, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shards = -(-n // shard)
    reads = host_copies("streaming")
    emit({"phase": "solve_streaming", "backend": res.backend, "n": n,
          "levels": res.levels, "shards": shards, "wall_s": wall,
          "n_sweeps": res.n_sweeps, "n_clusters": res.n_clusters.tolist(),
          "host_reads": reads, "launches": launch_counts()})
    check(res.backend == "sharded_streaming",
          f"solve(x, levels=1) on {n} points chose {res.backend}")
    e = res.exemplars[0]
    check(res.exemplars.shape == (1, n) and e.min() >= 0 and e.max() < n
          and res.n_clusters[0] == len(np.unique(e)),
          "sharded_streaming: bad exemplars")
    check(reads == shards + 2,
          f"sharded_streaming: {reads} host reads, expected "
          f"{shards + 2}")


def run_solve_coarsen():
    """The default ``solve(x)`` on 1,000,000 blobs: auto routes it to
    ``coarsen``; the kd cells, the local exemplars E and the global
    stage's backend (``dense_topk``, whose build is the fused kernel, once
    E > 4,096); the ``topk_build`` launches read around the call; the
    decisions against the same solve whose global stage builds with the
    reference scan, which must be identical. Returns the result."""
    from repro_torch.data import gaussian_blobs
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solver import SolveConfig, coarsen, solve

    x, _ = gaussian_blobs(n=N_COARSEN, k=16, seed=0, spread=0.5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(x, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, stats = launch_counts(), dict(coarsen.last_run)
    emit({"phase": "solve_coarsen", "backend": res.backend, "n": N_COARSEN,
          "levels": res.levels, "wall_s": wall, "n_sweeps": res.n_sweeps,
          "n_clusters": res.n_clusters.tolist(), **stats,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches})
    check(res.backend == "coarsen",
          f"solve(x) on {N_COARSEN} points chose {res.backend}")
    topk = stats["exemplars"] > SolveConfig().coarsen_global_dense_n
    check(stats["global_backend"] == ("dense_topk" if topk
                                      else "dense_parallel"),
          f"coarsen global stage ran {stats['global_backend']}")
    check(launches["topk_build"] == int(topk)
          and launches["similarity"] == launches["responsibility"]
          == launches["availability"] == 0,
          f"coarsen launches {launches}")
    for l in range(res.levels):
        e = res.exemplars[l]
        check(e.min() >= 0 and e.max() < N_COARSEN
              and res.n_clusters[l] == len(np.unique(e)),
              f"coarsen level {l}: bad exemplars")

    t0 = time.perf_counter()
    ref = solve(x, device=DEVICE, build="reference")
    torch.cuda.synchronize()
    same = (np.array_equal(res.exemplars, ref.exemplars)
            and np.array_equal(res.n_clusters, ref.n_clusters)
            and res.n_sweeps == ref.n_sweeps)
    emit({"phase": "solve_coarsen", "compare": "global stage: fused vs "
          "reference build", "reference_wall_s": time.perf_counter() - t0,
          "decisions_equal": same})
    check(same, "coarsen: the fused and reference global builds gave other "
          "decisions")
    return res


# ------------------------------------------- graph input and checkpoints
K_GRAPH = 64             # EdgeList.from_points(blobs, 64): the default k
GRAPH_LAYOUT = ROOT / "build" / "chip_smoke_graph" / "layout.npz"
N_ORACLE = 20_000        # blobs at which Borůvka is held to the oracle
CKPT_EVERY = 10          # sweeps between dense_topk checkpoints
COARSEN_CKPT_EVERY = 64  # coarsen batch groups between checkpoints (of 512)


def boruvka_oracle(el, target: int = 1):
    """Borůvka over a canonical edge list in numpy, by the contract of
    ``tests/test_graph.py`` (copied): per-cluster best edge = (max weight,
    min destination-leader id), mutual pairs hooked to the smaller id,
    pointer jumping to a fixed point. Returns (label snapshots, rounds)."""
    from repro_torch.core.assignments import flatten_pointers

    src, dst, w, n = el.src, el.dst, el.weight, el.n_nodes
    ids = np.arange(n)
    labels = ids.copy()
    hist = []
    while (labels == ids).sum() > target:
        ls, ld = labels[src], labels[dst]
        act = ls != ld
        if not act.any():
            break
        best_w = np.full(n, -np.inf)
        np.maximum.at(best_w, ls[act], w[act])
        ach = act & (w == best_w[ls])
        best_t = np.full(n, n)
        np.minimum.at(best_t, ls[ach], ld[ach])
        parent = ids.copy()
        has = best_t < n
        parent[has] = best_t[has]
        two = (parent[parent] == ids) & (ids < parent)
        parent[two] = ids[two]
        labels = flatten_pointers(parent)[labels]
        hist.append(labels.copy())
    return hist, len(hist)


def graph_layout(points, k: int) -> dict:
    """``EdgeList.from_points`` on the card (the fused kernel, its launches
    read around the call), then ``canonical()`` and ``to_topk()`` on the
    host, each timed; the edge set held bit for bit to the fused build's
    own output."""
    from repro_torch.graph import EdgeList
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.topk_build import topk_similarity_fused

    x = torch.from_numpy(points).to(DEVICE)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    el = EdgeList.from_points(x, k)
    build_s = time.perf_counter() - t0
    launches = launch_counts()
    check(launches["topk_build"] == 1,
          f"EdgeList.from_points launches {launches}")
    vals, idx = topk_similarity_fused(x, k)
    want = EdgeList.from_topk(vals.cpu().numpy(), idx.cpu().numpy())
    same = all(np.array_equal(getattr(el, f), getattr(want, f))
               for f in ("src", "dst", "weight"))
    check(same, "EdgeList.from_points: not the fused build's edge set")
    t0 = time.perf_counter()
    canon = el.canonical()
    canon_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tv, ti = canon.to_topk()
    to_topk_s = time.perf_counter() - t0
    return {"el": el, "canon": canon, "layout": (tv, ti), "line": {
        "n": len(points), "k": k, "from_points_s": build_s,
        "launches": launches, "edge_set_equals_fused_build": same,
        "directed_edges": el.n_edges, "canonical_edges": canon.n_edges,
        "canonical_s": canon_s, "to_topk_s": to_topk_s,
        "padded_degree": tv.shape[1],
        # what the round loop holds on the card: f32 weights, int64 ids
        "layout_device_bytes": tv.shape[0] * tv.shape[1] * (4 + 8)}}


def run_solve_graph(blobs, topk_default) -> dict:
    """Edge-list input: the blobs' top-k graph on ``graph_affinity``
    (against the port's own CPU run and, at 20,000 blobs, the numpy
    oracle), ``graph_affinity`` from points, the edges on ``dense_topk``
    (against the default solve with the same preference), and the default
    top-k solve with ``preseed="graph"`` (against ``build="reference"``
    at 20,000 blobs).
    Returns the ``topk_build`` launches of each path that builds, and the
    card's one-process round loop on the blobs' layout (which it writes to
    GRAPH_LAYOUT for solve_distributed)."""
    from repro_torch.graph import affinity
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solver import RawBackendResult, finalize_raw, solve

    n = blobs.shape[0]
    paths = {}
    g = graph_layout(blobs, K_GRAPH)
    paths["EdgeList.from_points"] = g["line"]["launches"]["topk_build"]
    emit({"phase": "solve_graph", "layout": "blobs", **g["line"]})
    el = g["el"]

    torch.cuda.synchronize()
    reset_launch_counts()
    obs.reset_counters("host_copies.graph_affinity")
    t0 = time.perf_counter()
    res = solve(el, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reads, launches = host_copies("graph_affinity"), launch_counts()
    emit({"phase": "solve_graph", "backend": res.backend, "levels":
          res.levels, "wall_s": wall, "rounds": res.n_sweeps,
          "host_reads": reads, "converged": res.converged,
          "trace": res.trace.tolist(), "n_clusters": res.n_clusters.tolist(),
          "launches": launches})
    check(res.backend == "graph_affinity",
          f"solve(EdgeList) chose {res.backend}")
    check(reads == res.n_sweeps and not any(launches.values()),
          f"graph_affinity: {reads} host reads for {res.n_sweeps} rounds, "
          f"launches {launches}")
    tv, ti = g["layout"]
    vals, idx = (torch.from_numpy(a).to(DEVICE) for a in (tv, ti))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = affinity.run_graph_affinity(vals, idx, levels=res.levels)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    del vals, idx
    # the layout and the one-process loop's result for the sharded
    # Borůvka of solve_distributed (the ranks load it, never re-sort it)
    GRAPH_LAYOUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez(GRAPH_LAYOUT, vals=tv, idx=ti)
    one_process = {"levels": res.levels, "digest": digest(card[0]),
                   "rounds": card[1], "converged": card[2],
                   "trace": card[3][:card[1]].tolist(), "wall_s": card_s}
    t0 = time.perf_counter()
    hist, r, conv, trace = affinity.run_graph_affinity(
        torch.from_numpy(tv), torch.from_numpy(ti), levels=res.levels)
    cpu_s = time.perf_counter() - t0
    cpu = finalize_raw(RawBackendResult(
        exemplars=hist, n_sweeps=r, converged=conv, trace=trace[:r]), n,
        "graph_affinity")
    same = (np.array_equal(res.exemplars, cpu.exemplars)
            and np.array_equal(res.labels, cpu.labels)
            and np.array_equal(res.trace, cpu.trace)
            and res.n_sweeps == cpu.n_sweeps
            and res.converged == cpu.converged)
    emit({"phase": "solve_graph", "compare": "card vs CPU, same layout",
          "card_round_loop_s": card_s, "cpu_round_loop_s": cpu_s,
          "labels_rounds_trace_equal": same})
    check(same, "graph_affinity on the card differs from the CPU")
    del g, hist

    small, _ = gaussian_blobs_n(N_ORACLE)
    o = graph_layout(small, K_GRAPH)
    paths["EdgeList.from_points (20,000)"] = \
        o["line"]["launches"]["topk_build"]
    tv, ti = o["layout"]
    hist, r, conv, trace = affinity.run_graph_affinity(
        torch.from_numpy(tv).to(DEVICE), torch.from_numpy(ti).to(DEVICE),
        levels=3)
    snaps, rounds = boruvka_oracle(o["canon"])
    # the backend may spend one more round, relabeling nothing
    snaps = [np.arange(N_ORACLE)] * 3 + snaps + \
        [snaps[-1]] * max(r - rounds, 0)
    same = bool(rounds <= r <= rounds + 1 and conv and all(
        np.array_equal(hist[l].cpu().numpy(), snaps[len(snaps) - 3 + l])
        for l in range(3)) and trace[rounds:r].sum() == 0)
    emit({"phase": "solve_graph", "compare": "card vs numpy oracle",
          "n": N_ORACLE, "rounds": r, "oracle_rounds": rounds,
          "converged": conv, "labels_equal": same,
          "n_clusters": int((hist[-1].cpu().numpy()
                             == np.arange(N_ORACLE)).sum())})
    check(same, "graph_affinity differs from the numpy oracle")
    del o

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    pts = solve(blobs, backend="graph_affinity", device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    paths["graph_affinity from points"] = launches["topk_build"]
    emit({"phase": "solve_graph", "backend": "graph_affinity",
          "input": "points", "wall_s": wall, "rounds": pts.n_sweeps,
          "n_clusters": pts.n_clusters.tolist(), "launches": launches,
          "equals_edge_list_solve": bool(
              np.array_equal(pts.exemplars, res.exemplars))})
    check(launches["topk_build"] == 1,
          f"graph_affinity from points: launches {launches}")
    check(np.array_equal(pts.exemplars, res.exemplars)
          and np.array_equal(pts.trace, res.trace),
          "graph_affinity from points differs from the edge-list solve")
    del pts, res

    # the edges natively on dense_topk, and the default solve on the same
    # edge set with the same preference (the edges' median, as a scalar)
    pref = float(el.edge_preferences("median")[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    nat = solve(el, backend="dense_topk", device=DEVICE, keep_state=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    kk = nat.state.idx.shape[1]
    same_pref = solve(blobs, device=DEVICE, preference=pref,
                      keep_state=True)
    same_layout = (torch.equal(nat.state.idx, same_pref.state.idx)
                   and torch.equal(nat.state.hap.s, same_pref.state.hap.s))
    same = (np.array_equal(nat.exemplars, same_pref.exemplars)
            and np.array_equal(nat.trace, same_pref.trace))
    default_same = bool(np.array_equal(nat.exemplars,
                                       topk_default.exemplars))
    emit({"phase": "solve_graph", "backend": "dense_topk", "input":
          "EdgeList (native)", "wall_s": wall, "kk": kk,
          "state_bytes": 3 * nat.levels * n * kk * 4,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "n_clusters": nat.n_clusters.tolist(), "launches": launches,
          "compare": {
              "same edges and preference (median of the edges, "
              f"{pref!r})": {"layout_equal": same_layout,
                             "decisions_equal": same},
              "default solve (sampled median)": {
                  "decisions_equal": default_same,
                  "why": "the default solve's preference is the median "
                         "of a 2,048-point dense subsample, the edge "
                         "list's the median of its stored weights; the "
                         "self-slot layout is the same"}}})
    check(not any(launches.values()),
          f"dense_topk on native edges launched {launches}")
    check(same_layout and same,
          "dense_topk: native edges and the default build with the same "
          "preference gave other decisions")
    del nat, same_pref, el

    torch.cuda.synchronize()
    reset_launch_counts()
    obs.reset_counters("host_copies.graph_affinity")
    t0 = time.perf_counter()
    pre = solve(blobs, preseed="graph", device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, reads = launch_counts(), host_copies("graph_affinity")
    paths["dense_topk preseed"] = launches["topk_build"]
    # the fused and reference builds under the preseed, at the 20,000
    # blobs (a depth cut: at 200,000 each run's host graph work took ~30 s)
    times, out = {}, {}
    for build in ("auto", "reference"):
        t0 = time.perf_counter()
        out[build] = solve(small, preseed="graph", build=build,
                           device=DEVICE)
        torch.cuda.synchronize()
        times[build] = time.perf_counter() - t0
    same = (np.array_equal(out["auto"].exemplars, out["reference"].exemplars)
            and np.array_equal(out["auto"].trace, out["reference"].trace))
    emit({"phase": "solve_graph", "backend": pre.backend,
          "preseed": "graph", "wall_s": wall, "preseed_host_reads": reads,
          "n_clusters": pre.n_clusters.tolist(),
          "plain_n_clusters": topk_default.n_clusters.tolist(),
          "launches": launches, "compare_n": N_ORACLE,
          "compare_wall_s": times,
          "compare_n_clusters": out["auto"].n_clusters.tolist(),
          "decisions_equal_reference_build": same})
    check(pre.backend == "dense_topk" and launches["topk_build"] == 1,
          f"preseed solve: {pre.backend}, launches {launches}")
    check(same, "preseed: fused and reference builds gave other decisions")
    return paths, one_process


def gaussian_blobs_n(n):
    from repro_torch.data import gaussian_blobs
    return gaussian_blobs(n=n, k=16, seed=0, spread=0.5)


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def run_solve_checkpoint(blobs, coarsen_res) -> dict:
    """The default ``dense_topk`` solve of the blobs under both stops, run
    plain, checkpointed every CKPT_EVERY sweeps, crashed at the second
    save and resumed, and resumed from a copy of the crashed directory:
    state, decisions and trace bit-equal across the four. Then coarsen
    on 1,000,000 points crashed mid-local and after the global save, each
    resumed to the uninterrupted solve's decisions. Returns the
    ``topk_build`` launches of each path."""
    import shutil

    from repro_torch import convert
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import faultinject
    from repro_torch.solver import solve

    base = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    save_ms = []
    save = CheckpointManager.save

    def timed_save(self, step, tree):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(self, step, tree)
        save_ms.append((time.perf_counter() - t0) * 1e3)

    def run(label, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(blobs, device=DEVICE, keep_state=True, **kw)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        return res

    CheckpointManager.save = timed_save
    paths = {}
    try:
        for stop in ("fixed", "converged"):
            walls, save_ms[:] = {}, []
            a, b, c = (base / f"{stop}_{d}" for d in "abc")
            runs = {"plain": run("plain", stop=stop)}
            reset_launch_counts()
            runs["checkpointed"] = run("checkpointed", stop=stop,
                                       checkpoint_every=CKPT_EVERY,
                                       checkpoint_dir=str(a))
            launches = launch_counts()
            paths[f"dense_topk checkpointed ({stop})"] = \
                launches["topk_build"]
            check(launches["topk_build"] == 1,
                  f"checkpointed dense_topk launches {launches}")
            step_bytes = dir_bytes(a / f"step_{runs['plain'].n_sweeps:010d}")
            shutil.rmtree(a)
            inj = faultinject.FaultInjector().add(
                faultinject.Rule("solver.sweep", nth=1))
            crashed = False
            t0 = time.perf_counter()
            try:
                with faultinject.active(inj):
                    run("crashed", stop=stop, checkpoint_every=CKPT_EVERY,
                        checkpoint_dir=str(b))
            except faultinject.InjectedFault:
                crashed = True
            walls["crashed"] = time.perf_counter() - t0
            check(crashed, "the injected fault did not fire")
            shutil.copytree(b, c)
            t0 = time.perf_counter()
            carry = convert.carry_from_checkpoint(str(b), DEVICE)
            torch.cuda.synchronize()
            resume_ms = (time.perf_counter() - t0) * 1e3
            resumed_at = carry[3]
            del carry
            runs["resumed"] = run("resumed", stop=stop,
                                  checkpoint_every=CKPT_EVERY,
                                  checkpoint_dir=str(b), resume_from=str(b))
            runs["resumed from a copy"] = run("resumed from a copy",
                                              stop=stop, resume_from=str(c))
            shutil.rmtree(b)
            shutil.rmtree(c)
            ref = runs["plain"]
            equal = {}
            for name, r in runs.items():
                equal[name] = (
                    np.array_equal(r.exemplars, ref.exemplars)
                    and np.array_equal(r.labels, ref.labels)
                    and np.array_equal(r.trace, ref.trace)
                    and r.n_sweeps == ref.n_sweeps
                    and r.converged == ref.converged
                    and all(torch.equal(p, q) for p, q
                            in zip(r.state.hap, ref.state.hap)))
            emit({"phase": "solve_checkpoint", "backend": ref.backend,
                  "stop": stop, "n": blobs.shape[0], "every": CKPT_EVERY,
                  "n_sweeps": ref.n_sweeps, "converged": ref.converged,
                  "wall_s": walls, "save_ms": list(save_ms),
                  "bytes_per_step": step_bytes, "resumed_at_sweep":
                  resumed_at, "resume_ms": resume_ms,
                  "bit_equal_to_plain": equal})
            check(all(equal.values()),
                  f"checkpointed runs differ from the plain run: {equal}")
            del runs, ref
    finally:
        CheckpointManager.save = save

    x, _ = gaussian_blobs_n(N_COARSEN)
    for stage, rule in (("local", faultinject.Rule(
            "solver.coarsen", nth=3, match={"stage": "local"})),
            ("global", faultinject.Rule(
                "solver.coarsen", match={"stage": "global"}))):
        d = base / f"coarsen_{stage}"
        kw = dict(device=DEVICE, checkpoint_every=COARSEN_CKPT_EVERY,
                  checkpoint_dir=str(d))
        inj = faultinject.FaultInjector().add(rule)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with faultinject.active(inj):
                solve(x, **kw)
            crashed = False
        except faultinject.InjectedFault:
            crashed = True
        crash_s = time.perf_counter() - t0
        crash_launches = launch_counts()
        check(crashed, f"coarsen {stage}: the injected fault did not fire")
        resumed = faultinject.FaultInjector()
        reset_launch_counts()
        t0 = time.perf_counter()
        with faultinject.active(resumed):
            res = solve(x, resume_from=str(d), **kw)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        launches = launch_counts()
        shutil.rmtree(d)
        same = (np.array_equal(res.exemplars, coarsen_res.exemplars)
                and np.array_equal(res.n_clusters, coarsen_res.n_clusters)
                and res.n_sweeps == coarsen_res.n_sweeps)
        built = crash_launches["topk_build"] + launches["topk_build"]
        paths[f"coarsen crashed at {stage}, resumed"] = built
        emit({"phase": "solve_checkpoint", "backend": res.backend,
              "n": N_COARSEN, "crash_at": stage, "crash_wall_s": crash_s,
              "resume_wall_s": resume_s,
              "stage_boundaries": {"crashed_run": inj.hits("solver.coarsen"),
                                   "resumed_run":
                                       resumed.hits("solver.coarsen")},
              "launches": {"crashed_run": crash_launches,
                           "resumed_run": launches},
              "decisions_equal_uninterrupted": same})
        check(same, f"coarsen resumed after a {stage} crash differs")
        # the global stage's build runs once: in the resumed run after a
        # local crash, in the crashed run after a global one
        check(built == 1, f"coarsen {stage}: topk_build launched {built}")
    shutil.rmtree(base, ignore_errors=True)
    return paths


# ------------------------------------------------------------ serve phase
# benchmarks/bench_serve.py's FULL and CHAOS_FULL tiers
SERVE_BUCKETS = [(128, 2), (256, 2), (512, 2)]
SERVE_BATCH = 8
SERVE_LOADS = [5.0, 20.0, 50.0, 100.0]
SERVE_REQUESTS = 40            # benchmarks/bench_serve.py's FULL: 120
SERVE_STREAM_FRAC = 0.5
CEILING = (4096, 2, 8)        # the largest bucket max_bucket_n lets batch
CEILING_REQUESTS = 16
N_SERVE_TOPK = 20_000         # overflow -> dense_topk (k = 64)
N_SERVE_COARSEN = 250_000     # overflow -> coarsen (past 200,000)
CHAOS = {"buckets": [(64, 2)], "batch": 4, "rps": 40.0, "requests": 80,
         "max_iterations": 60, "workers": 4, "kills": 3,
         "cooldown_s": 0.2, "deadline_ms": 2000.0}


def serve_config(**kw):
    from repro_torch.solver import SolveConfig
    base = dict(stop="converged", max_iterations=100, damping=0.6,
                levels=2, preference="median", seed=0)
    return SolveConfig(**{**base, **kw})


def serve_responses_equal(a, b) -> tuple[bool, bool, int, int]:
    """(decisions equal, traces equal, points with another finest-level
    exemplar, points) for two lists of responses to the same requests.
    Decisions: path, bucket, stream generation, labels, exemplars, sweep
    count and flag."""
    same, traces, differ, total = True, True, 0, 0
    for x, y in zip(a, b):
        total += len(x.labels)
        same &= (x.path, x.bucket, x.generation) == (y.path, y.bucket,
                                                      y.generation)
        same &= np.array_equal(x.labels, y.labels)
        if x.solve is not None:
            differ += int((x.solve.exemplars[0]
                           != y.solve.exemplars[0]).sum())
            same &= (np.array_equal(x.solve.exemplars, y.solve.exemplars)
                     and x.solve.n_sweeps == y.solve.n_sweeps
                     and x.solve.converged == y.solve.converged)
            traces &= np.array_equal(x.solve.trace, y.solve.trace)
    return same, traces, differ, total


def serve_breakdown(svc) -> list[dict]:
    """Where a full batch's time goes, per bucket: host padding, the
    batched launch (the handle's ``run``, which reads its results back),
    and the host's slicing and finishing of each rider."""
    from repro_torch.serve.cluster import Bucket
    from repro_torch.serve.cluster.loadgen import synthetic_requests
    from repro_torch.solver import finalize_raw
    from repro_torch.solver.compiled import slice_request

    out = []
    for n, d in SERVE_BUCKETS:
        bucket = Bucket(n, d, SERVE_BATCH)
        reqs = synthetic_requests(SERVE_BATCH, [(n, d)], seed=n)
        solver = svc.workers[0].cache.lookup(bucket, svc.config)
        rows = []
        for _ in range(3):
            t0 = time.perf_counter()
            pts = np.zeros((bucket.batch, n, d), np.float32)
            n_real = np.array([len(r) for r in reqs], np.int32)
            for i, r in enumerate(reqs):
                pts[i] = svc.router.pad_points(r, bucket)
            t1 = time.perf_counter()
            raw = solver.run(pts, n_real)
            t2 = time.perf_counter()
            for i, r in enumerate(reqs):
                rbr, _ = slice_request(raw, i, len(r), svc.config.stop)
                finalize_raw(rbr, len(r), "serve_batched")
            t3 = time.perf_counter()
            rows.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
                         int(raw.n_sweeps.max())))
        pad, run, finish, sweeps = rows[-1]
        out.append({"bucket": bucket.key, "pad_ms": pad, "launch_ms": run,
                    "finish_ms": finish, "max_sweeps": sweeps,
                    "launch_ms_runs": [r[1] for r in rows]})
    return out


def fast_path_latency() -> dict:
    """The stream fast path's assignment (``assign_nearest_exemplar``) on
    the host, as the service runs it, against the same call on the card
    with the copies there and back, at a stream's shapes."""
    from repro_torch.core.streaming import assign_nearest_exemplar

    rng = np.random.default_rng(0)
    out = {}
    for n, k in ((64, 8), (256, 16), (512, 32)):
        x = rng.normal(size=(n, 2)).astype(np.float32)
        ex = rng.normal(size=(k, 2)).astype(np.float32)

        def host():
            lab, best = assign_nearest_exemplar(x, ex)
            return lab.numpy(), best.numpy()

        def card():
            lab, best = assign_nearest_exemplar(
                torch.from_numpy(x).to(DEVICE), torch.from_numpy(ex).to(
                    DEVICE))
            return lab.cpu().numpy(), best.cpu().numpy()

        res = {}
        for name, fn in (("host_us", host), ("card_us", card)):
            got = fn()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            res[name] = (time.perf_counter() - t0) / 200 * 1e6
            res[name.replace("_us", "_labels")] = got[0]
        check(np.array_equal(res.pop("host_labels"), res.pop("card_labels")),
              f"fast path: host and card labels differ at {n}x{k}")
        out[f"{n}x{k}"] = res
    return out


def run_serve(smi: str) -> dict:
    """The clustering service (``repro_torch.serve.cluster``) on the card:
    the load sweep, the ceiling bucket, decisions against the CPU, the two
    overflow routes, worker failures and the ``cluster_serve`` driver.
    Returns the ``topk_build`` launches of the overflow paths."""
    from repro_torch.data import gaussian_blobs
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import faultinject
    from repro_torch.runtime.faultinject import FaultInjector, Rule
    from repro_torch.serve.cluster import ClusterService
    from repro_torch.serve.cluster.loadgen import run_load, synthetic_requests
    from repro_torch.solver import solve

    t_phase = time.perf_counter()
    cfg = serve_config()
    buckets = [(n, d, SERVE_BATCH) for n, d in SERVE_BUCKETS]
    svc = ClusterService(config=cfg, buckets=buckets)
    warm = svc.warmup()
    check(warm["misses"] == 3 * 4, f"serve warmup: {warm}")
    emit({"phase": "serve", "step": "warmup", "card": smi,
          "devices": [str(w.device) for w in svc.workers], **warm})

    # -- the load sweep (bench_serve.py FULL)
    reset_launch_counts()
    rows = []
    for load in SERVE_LOADS:
        before = svc.snapshot()
        reqs = synthetic_requests(SERVE_REQUESTS, SERVE_BUCKETS,
                                  seed=int(load))
        res = run_load(svc, reqs, rps=load, stream="bench",
                       stream_frac=SERVE_STREAM_FRAC, seed=0,
                       timeout=120.0)
        after = svc.snapshot()
        batches = after["micro_batches"] - before["micro_batches"]
        riders = ((after["full_solves"] - before["full_solves"])
                  - (after["overflow_solves"] - before["overflow_solves"]))
        row = {"offered_rps": res.offered_rps,
               "achieved_rps": res.achieved_rps, "p50_ms": res.p50_ms,
               "p95_ms": res.p95_ms, "p99_ms": res.p99_ms,
               "mean_ms": res.mean_ms, "first_ms": res.first_ms,
               "micro_batches": batches,
               "mean_riders": riders / batches if batches else 0.0,
               "fast_frac": res.fast_frac, "n_requests": res.n_requests,
               "n_errors": res.n_errors, "duration_s": res.duration_s,
               "cache_misses": after["cache"]["misses"]
               - before["cache"]["misses"]}
        rows.append(row)
        emit({"phase": "serve", "step": "load", **row})
        check(res.n_errors == 0, f"serve load {load}: {res.n_errors} errors")
        check(row["cache_misses"] == 0,
              f"serve load {load}: {row['cache_misses']} request-path "
              "cache misses")
    batched_launches = launch_counts()
    est = {str(k): v for k, v in svc.workers[0]._est_s.items()}
    emit({"phase": "serve", "step": "micro_batched_launches",
          "launches": batched_launches, "launch_ewma_s": est})
    check(sum(batched_launches.values()) == 0,
          f"the micro-batched path launched kernels: {batched_launches}")
    emit({"phase": "serve", "step": "breakdown",
          "buckets": serve_breakdown(svc),
          "fast_path": fast_path_latency()})

    # -- the ceiling bucket
    ceil = ClusterService(config=cfg, buckets=[CEILING], auto_bucket=False)
    ceil.warmup()
    reqs = synthetic_requests(CEILING_REQUESTS, [CEILING[:2]], seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    futs = [ceil.submit(x) for x in reqs]
    ceil.drain()
    wall = time.perf_counter() - t0
    out = [f.result(timeout=600) for f in futs]
    snap = ceil.snapshot()
    emit({"phase": "serve", "step": "ceiling", "bucket": CEILING,
          "requests": len(out), "micro_batches": snap["micro_batches"],
          "wall_s": wall, "ms_per_launch": [r.solve_ms for r in out[::8]],
          "n_sweeps": [int(r.solve.n_sweeps) for r in out],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "state_bytes": 3 * 4 * CEILING[2] * cfg.levels * CEILING[0] ** 2})
    check(all(r.path == "full" and r.bucket == CEILING for r in out),
          "ceiling bucket: a request took another path")
    del ceil, out, futs
    torch.cuda.empty_cache()

    # -- decisions on the card against the CPU
    reqs = synthetic_requests(16, SERVE_BUCKETS, seed=7)
    streams = ["cmp" if i % 4 == 0 else None for i in range(len(reqs))]
    answers = {}
    for device in (None, "cpu"):
        s = ClusterService(config=serve_config(device=device),
                           buckets=buckets)
        s.warmup()
        t0 = time.perf_counter()
        futs = [s.submit(x, stream=st) for x, st in zip(reqs, streams)]
        s.drain()
        futs += [s.submit(x[: len(x) // 2], stream="cmp")
                 for x in reqs[:4]]
        s.drain()
        answers[device or "cuda"] = ([f.result(timeout=600) for f in futs],
                                     time.perf_counter() - t0)
    same, traces, differ, total = serve_responses_equal(
        answers["cuda"][0], answers["cpu"][0])
    pairs = list(zip(answers["cuda"][0], answers["cpu"][0]))
    gap = max((int(np.abs(a.solve.trace.astype(np.int64)
                          - b.solve.trace).max(initial=0))
               for a, b in pairs if a.solve is not None
               and len(a.solve.trace) == len(b.solve.trace)), default=0)
    emit({"phase": "serve", "step": "card_vs_cpu", "requests": len(reqs),
          "responses": len(pairs), "decisions_equal": same,
          "traces_equal": traces, "points_with_other_exemplar": differ,
          "points": total,
          "requests_with_other_decisions": sum(
              not serve_responses_equal([a], [b])[0] for a, b in pairs),
          "requests_with_other_trace": sum(
              not serve_responses_equal([a], [b])[1] for a, b in pairs),
          "largest_trace_gap": gap,
          "card_s": answers["cuda"][1], "cpu_s": answers["cpu"][1]})
    check(differ <= MAX_MISMATCH * total,
          f"serve card vs cpu: {differ} of {total} points differ")

    # -- overflow to dense_topk
    paths = {}
    x, _ = gaussian_blobs(n=N_SERVE_TOPK, k=16, seed=0, spread=0.5)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = svc.solve_sync(x, stream="big")
    wall = time.perf_counter() - t0
    launches = launch_counts()
    paths["serve overflow dense_topk"] = launches["topk_build"]
    direct = solve(x, cfg.replace(backend="dense_topk", k=64,
                                  input_kind="points"))
    scan = solve(x, cfg.replace(backend="dense_topk", k=64,
                                input_kind="points", build="reference"))
    eq = {name: bool(np.array_equal(res.solve.exemplars, o.exemplars)
                     and np.array_equal(res.solve.trace, o.trace)
                     and res.solve.n_sweeps == o.n_sweeps)
          for name, o in (("direct", direct), ("reference_build", scan))}
    emit({"phase": "serve", "step": "overflow_dense_topk", "n": N_SERVE_TOPK,
          "backend": res.solve.backend, "wall_s": wall,
          "solve_ms": res.solve_ms, "n_sweeps": res.solve.n_sweeps,
          "n_clusters": res.solve.n_clusters.tolist(),
          "stream": svc.stream_info("big"), "launches": launches,
          "decisions_equal": eq})
    # a sampled median for the solve and one for the stream's preference
    check(res.solve.backend == "dense_topk" and launches["topk_build"] == 1
          and launches["median_select"] == 2 and sum(launches.values()) == 3,
          f"serve overflow dense_topk: {res.solve.backend}, {launches}")
    check(all(eq.values()), f"serve overflow dense_topk differs: {eq}")

    # -- overflow to coarsen
    x, _ = gaussian_blobs(n=N_SERVE_COARSEN, k=16, seed=0, spread=0.5)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = svc.solve_sync(x)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    paths["serve overflow coarsen"] = launches["topk_build"]
    from repro_torch.solver import coarsen
    stats = dict(coarsen.last_run)
    direct = solve(x, cfg.replace(backend="coarsen"))
    same = bool(np.array_equal(res.solve.exemplars, direct.exemplars)
                and res.solve.n_sweeps == direct.n_sweeps)
    emit({"phase": "serve", "step": "overflow_coarsen", "n": N_SERVE_COARSEN,
          "backend": res.solve.backend, "wall_s": wall, **stats,
          "n_clusters": res.solve.n_clusters.tolist(), "launches": launches,
          "decisions_equal_direct": same})
    check(res.solve.backend == "coarsen"
          and stats["global_backend"] == "dense_topk"
          and launches["topk_build"] == 1 and launches["median_select"] == 1
          and sum(launches.values()) == 2,
          f"serve overflow coarsen: {stats}, {launches}")
    check(same, "serve overflow coarsen differs from the direct solve")
    snap = svc.snapshot()
    check(snap["overflow_solves"] == 2
          and snap["overflow_coarsen_solves"] == 1,
          f"serve overflow counters: {snap['overflow_solves']}, "
          f"{snap['overflow_coarsen_solves']}")
    del svc

    # -- worker failures (bench_serve.py CHAOS_FULL), four workers, one card
    chaos = ClusterService(
        config=serve_config(max_iterations=CHAOS["max_iterations"]),
        buckets=[(n, d, CHAOS["batch"]) for n, d in CHAOS["buckets"]],
        auto_bucket=False, workers=CHAOS["workers"], max_wait_ms=1.0,
        max_retries=3, worker_cooldown_s=CHAOS["cooldown_s"],
        retry_backoff_ms=2.0)
    chaos.warmup()

    def load(seed):
        return run_load(
            chaos, synthetic_requests(CHAOS["requests"], CHAOS["buckets"],
                                      seed=seed),
            rps=CHAOS["rps"], seed=seed, deadline_ms=CHAOS["deadline_ms"],
            timeout=120.0)

    baseline = load(1)
    inj = FaultInjector(seed=7).add(Rule(
        "serve.launch", nth=0, times=CHAOS["kills"], match={"worker": 1}))
    with faultinject.active(inj):
        under = load(2)
    recovered = load(3)
    s = chaos.stats

    def hard(r):                # neither a deadline miss nor a shed
        return r.n_errors - r.n_deadline - r.n_shed

    emit({"phase": "serve", "step": "chaos",
          "p99_ms": [baseline.p99_ms, under.p99_ms, recovered.p99_ms],
          "p50_ms": [baseline.p50_ms, under.p50_ms, recovered.p50_ms],
          "errors": [baseline.n_errors, under.n_errors, recovered.n_errors],
          "deadline_misses": [baseline.n_deadline, under.n_deadline,
                              recovered.n_deadline],
          "achieved_rps": [baseline.achieved_rps, under.achieved_rps,
                           recovered.achieved_rps],
          "requests": [baseline.n_requests, under.n_requests,
                       recovered.n_requests],
          "injected_faults": len(inj.events),
          "worker_deaths": s.worker_deaths,
          "retried_batches": s.retried_batches,
          "requeued_requests": s.requeued_requests,
          "resurrections": s.resurrections,
          "devices": sorted({str(w.device) for w in chaos.workers})})
    # every future resolved (run_load waits on each); a deadline miss is
    # the service working as configured, any other error is a failure
    check(hard(baseline) == hard(under) == hard(recovered) == 0,
          "serve chaos: futures failed other than by their deadline")
    # the same load on one worker: what the three extra threads add
    solo = ClusterService(
        config=serve_config(max_iterations=CHAOS["max_iterations"]),
        buckets=[(n, d, CHAOS["batch"]) for n, d in CHAOS["buckets"]],
        auto_bucket=False, max_wait_ms=1.0)
    solo.warmup()
    one = run_load(
        solo, synthetic_requests(CHAOS["requests"], CHAOS["buckets"],
                                 seed=1),
        rps=CHAOS["rps"], seed=1, deadline_ms=CHAOS["deadline_ms"],
        timeout=120.0)
    emit({"phase": "serve", "step": "chaos_one_worker",
          "p50_ms": one.p50_ms, "p99_ms": one.p99_ms,
          "deadline_misses": one.n_deadline,
          "achieved_rps": one.achieved_rps,
          "micro_batches": solo.snapshot()["micro_batches"]})
    check(hard(one) == 0, "serve one worker: futures failed")
    check(len(inj.events) == CHAOS["kills"] and s.worker_deaths >= 1
          and s.retried_batches >= 1,
          f"serve chaos: {len(inj.events)} kills, {s.worker_deaths} "
          f"deaths, {s.retried_batches} retried batches")
    del chaos

    # -- the driver
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster_serve",
         "--smoke"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    emit({"phase": "serve", "step": "driver", "rc": proc.returncode,
          "seconds": time.perf_counter() - t0,
          "stdout": proc.stdout.strip().splitlines()[-4:],
          "stderr": proc.stderr.strip().splitlines()[-3:]})
    check(proc.returncode == 0, "cluster_serve --smoke failed")
    emit({"phase": "serve", "step": "done",
          "seconds": time.perf_counter() - t_phase})
    return paths


# ---------------------------------------------------------------- attention
MAX_BF16_DIFFER = 0.05   # share of bf16 outputs that may round a step apart


def gqa_qkv(g, batch, heads, kv_heads, seq, d, dtype):
    """q (batch * heads, seq, d) and k, v with the KV heads broadcast to
    the query heads before folding, as callers of ``ops.flash_attention``
    do (query head h reads KV head h // (heads / kv_heads))."""
    q = torch.randn(batch, heads, seq, d, generator=g, device=DEVICE)
    k, v = (torch.randn(batch, kv_heads, seq, d, generator=g, device=DEVICE)
            .repeat_interleave(heads // kv_heads, dim=1) for _ in range(2))
    return [t.reshape(batch * heads, seq, d).to(dtype).contiguous()
            for t in (q, k, v)]


def attention_branches(sq: int, sk: int, d: int, dtype: torch.dtype,
                       causal: bool) -> dict:
    """Which of the kernel's masking branches a call of this shape reaches:
    masked columns inside a diagonal tile, the ragged last key tile (when
    a causal block reaches it), and query rows >= Sk that see every
    key."""
    from repro_torch.kernels.flash_attention import block_k, block_q
    step, rows = block_k(d, dtype), block_q(d, dtype)
    last_tile = sk - sk % step
    reached = not causal or -(-sq // rows) * rows > last_tile
    return {"masked_cols_in_diagonal_tile": causal and sk > 1,
            "ragged_last_key_tile": sk % step != 0 and reached,
            "rows_past_sk_see_every_key": causal and sq > sk}


def attention_cases() -> list[tuple]:
    """(name, q, k, v, causal, timed): the prefill geometry of three models
    of ``src/repro/configs/registry.py``, then the coverage shapes."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def rand(bh, sq, sk, d, dtype, q_scale=1.0):
        q, k, v = (torch.randn(bh, s, d, generator=g, device=DEVICE)
                   for s in (sq, sk, sk))
        return [t.to(dtype) for t in (q * q_scale, k, v)]

    return [
        # tinyllama-1.1b: 32 heads, 4 KV heads, head_dim 64; batch 8 x 2,048
        ("tinyllama_bf16", *gqa_qkv(g, 8, 32, 4, 2048, 64, bf16), True, True),
        ("tinyllama_f32", *gqa_qkv(g, 8, 32, 4, 2048, 64, f32), True, True),
        # qwen2.5-32b: 40 heads, 8 KV heads, head_dim 128; batch 2 x 4,096
        ("qwen2.5_bf16", *gqa_qkv(g, 2, 40, 8, 4096, 128, bf16), True, True),
        # recurrentgemma-9b: 16 heads, 1 KV head, head_dim 256; batch 8 x
        # 2,048 (its local-attention window, 2,048, spans the sequence)
        ("recurrentgemma_bf16", *gqa_qkv(g, 8, 16, 1, 2048, 256, bf16), True,
         True),
        ("d256_f32", *rand(8, 1024, 1024, 256, f32), True, False),
        ("d256_bf16", *rand(8, 1024, 1024, 256, bf16), True, False),
        ("ragged_causal_f32", *rand(16, 1000, 1000, 64, f32), True, False),
        ("ragged_causal_bf16", *rand(16, 1000, 1000, 64, bf16), True, False),
        ("noncausal_ragged_sk_f32", *rand(16, 1000, 1000, 64, f32), False,
         False),
        ("rect_192x320_f32", *rand(16, 192, 320, 128, f32), True, False),
        ("sq600_sk300_f32", *rand(16, 600, 300, 64, f32), True, False),
        ("sq600_sk300_bf16", *rand(16, 600, 300, 64, bf16), True, False),
        # q x 4: a few keys carry each row, where a p rounded once to bf16
        # would put outputs beyond the tolerance
        ("concentrated_bf16", *rand(16, 1024, 1024, 64, bf16, 4.0), True,
         False),
    ]


def run_attention() -> dict:
    """``ops.flash_attention`` against its plain version on the card at
    each case; returns the kernels-line summary of the main case
    (tinyllama, bf16) and its launch count."""
    from repro_torch.kernels import (
        _build, flash_attention, launch_counts, ops, reset_launch_counts,
    )
    emit({"phase": "attention", "ptxas": [
        ln for ln in _build.build_info().ptxas["flash_attention.cu"]
        if "entry function" in ln or "Used" in ln or "spill" in ln]})
    summary = {"max_abs_err": 0.0}
    for name, q, k, v, causal, timed_case in attention_cases():
        bh, sq, d = q.shape
        sk = k.shape[1]
        reset_launch_counts()
        got = ops.flash_attention(q, k, v, causal=causal)
        counts = launch_counts()
        again = ops.flash_attention(q, k, v, causal=causal)
        want = flash_attention.plain(q, k, v, causal)
        torch.cuda.synchronize()
        check(counts == {"similarity": 0, "responsibility": 0,
                         "availability": 0, "topk_build": 0,
                         "flash_attention": 1, "median_select": 0},
              f"attention {name}: launches {counts}")
        check(got.dtype == q.dtype and got.shape == q.shape
              and bool(torch.isfinite(got).all()),
              f"attention {name}: bad output")
        check(torch.equal(got, again), f"attention {name}: re-run differs")
        err = (got.float() - want.float()).abs()
        tol = flash_attention.tolerance(want)
        share = sampled_median(tol) / sampled_median(want.float().abs())
        differ = float((err > 0).float().mean())
        line = {"phase": "attention", "case": name, "bh": bh, "sq": sq,
                "sk": sk, "d": d, "causal": causal,
                "dtype": str(q.dtype).split(".")[-1],
                "branches": attention_branches(sq, sk, d, q.dtype, causal),
                "launches": counts["flash_attention"],
                "max_abs_err": float(err.max()),
                "max_err_over_tolerance": float((err / tol).max()),
                "share_differ": differ,
                "tolerance": (
                    f"{flash_attention.F32_ATOL:g} + "
                    f"{flash_attention.F32_RTOL:g} |plain|"
                    + (" + one bf16 step of |plain|"
                       if q.dtype == torch.bfloat16 else "")
                    + f" (median tolerance / median |output| {share:.3g})")}
        check(bool((err <= tol).all()),
              f"attention {name}: error {float(err.max())} beyond tolerance")
        if q.dtype == torch.float32:
            check(share <= MAX_TOL_SHARE,
                  f"attention {name}: tolerance {share:.3g} of a typical "
                  "output is too loose to fail a wrong kernel")
        else:
            check(differ <= MAX_BF16_DIFFER,
                  f"attention {name}: {differ:.2%} of outputs differ")
        summary["max_abs_err"] = max(summary["max_abs_err"], float(err.max()))
        if timed_case:
            bf16 = q.dtype == torch.bfloat16
            peak = BF16_OPS_PER_S if bf16 else F32_SPLIT_OPS_PER_S
            b_ms, b_by = bound_ms(
                flash_attention.nbytes(q, k, v),
                flash_attention.operations(bh, sq, sk, d, causal), peak)
            k_ms = cuda_ms(lambda: ops.flash_attention(q, k, v,
                                                       causal=causal),
                           iters=5)
            p_ms = cuda_ms(lambda: flash_attention.plain(q, k, v, causal),
                           iters=1, warmup=1)
            # (1, BH, S, D) views: SDPA takes its fused kernels only for
            # 4-D inputs (3-D ones run its plain math path)
            l_ms = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=causal), iters=5)
            tc_ops = flash_attention.tensor_core_operations(
                bh, sq, sk, d, causal, q.dtype)
            line.update(kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                        bound_by=b_by, bound_share=b_ms / k_ms,
                        library_ms=l_ms,
                        library="torch.nn.functional."
                        "scaled_dot_product_attention(is_causal=True)",
                        peak_ops_per_s=peak,
                        tensor_core_tflops=tc_ops / k_ms / 1e9,
                        tensor_core_peak_tflops=(
                            BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S)
                        / 1e12)
            if name == "tinyllama_bf16":
                summary.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=l_ms,
                               launches=counts["flash_attention"])
        emit(line)
        del q, k, v, got, again, want, err, tol
    return summary


# --------------------------------------------------------- two-stage build
def sync_us(reps: int = 200) -> float:
    """Host round trip of one "any?" read of a small device tensor, as the
    two-stage build makes one per round and per residual slab (us)."""
    t = torch.ones(1024, device=DEVICE)
    bool((t > 0).any())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        bool((t > 0).any())
    return (time.perf_counter() - t0) / reps * 1e6


def run_solve_twostage(blobs, pixels) -> None:
    """``solve(x, metric="neg_euclidean")`` on the 200,000 blobs: auto
    routes it to dense_topk with the two-stage build; held against
    ``build="reference"``. Then the two-stage build alone with cosine on
    the 512 x 512 Mandrill pixels against the reference scan."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solver import SolveConfig, solve
    from repro_torch.solver.topk_build import (
        build_topk_similarity, resolve_build_backend,
    )

    n, metric = blobs.shape[0], "neg_euclidean"
    build = resolve_build_backend("auto", n=n, k=K_TOPK, metric=metric,
                                  platform="cuda")
    check(build == "twostage", f"{metric} build resolves to {build}")
    first = solve(blobs, metric=metric, device=DEVICE, keep_state=True)
    check(first.backend == "dense_topk",
          f"auto-select on {n} points chose {first.backend}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    obs.reset_counters("host_copies.twostage_build")
    t0 = time.perf_counter()
    res = solve(blobs, metric=metric, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, syncs = launch_counts(), host_copies("twostage_build")
    emit({"phase": "solve_twostage", "backend": res.backend, "build": build,
          "metric": metric, "n": n, "k": K_TOPK, "levels": res.levels,
          "wall_s": wall, "n_sweeps": res.n_sweeps,
          "n_clusters": res.n_clusters.tolist(), "host_syncs": syncs,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches})
    # neither the two-stage build nor the sparse sweep has a kernel; the
    # sampled median takes its own
    check(launches == {**dict.fromkeys(launches, 0), "median_select": 1},
          f"launches {launches}")
    check(np.array_equal(res.exemplars, first.exemplars)
          and np.array_equal(res.trace, first.trace),
          "two-stage solve: a second solve gave other decisions")
    t0 = time.perf_counter()
    ref = solve(blobs, metric=metric, device=DEVICE, build="reference",
                keep_state=True)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    same_edges = (torch.equal(first.state.idx, ref.state.idx)
                  and torch.equal(first.state.hap.s, ref.state.hap.s))
    emit({"phase": "solve_twostage", "compare": "twostage vs reference "
          "build", "reference_wall_s": ref_wall,
          "edge_sets_equal": same_edges,
          "exemplars_equal": bool(np.array_equal(first.exemplars,
                                                 ref.exemplars)),
          "n_clusters_equal": bool(np.array_equal(first.n_clusters,
                                                  ref.n_clusters)),
          "trace_equal": bool(np.array_equal(first.trace, ref.trace))})
    check(same_edges, "two-stage and reference builds stored other edges")
    check(np.array_equal(first.exemplars, ref.exemplars)
          and np.array_equal(first.n_clusters, ref.n_clusters)
          and np.array_equal(first.trace, ref.trace)
          and first.n_sweeps == ref.n_sweeps,
          "two-stage and reference builds gave other decisions")
    del first, ref, res

    round_trip = sync_us()
    for case, pts, met in (("blobs", blobs, metric),
                           ("pixels_512", pixels, "cosine")):
        x = torch.from_numpy(pts).to(DEVICE)
        cfg = SolveConfig(metric=met)
        check(resolve_build_backend("auto", n=x.shape[0], k=K_TOPK,
                                    metric=met, platform="cuda")
              == "twostage", f"{case}: auto does not take twostage")
        obs.reset_counters("host_copies.twostage_build")
        t0 = time.perf_counter()
        two, two_ms = timed(lambda: build_topk_similarity(
            x, K_TOPK, cfg.replace(build="twostage")))
        two_wall = time.perf_counter() - t0
        syncs = host_copies("twostage_build")
        ref, ref_ms = timed(lambda: build_topk_similarity(
            x, K_TOPK, cfg.replace(build="reference")))
        equal = torch.equal(two[0], ref[0]) and torch.equal(two[1], ref[1])
        emit({"phase": "solve_twostage", "build_case": case,
              "n": x.shape[0], "d": x.shape[1], "metric": met, "k": K_TOPK,
              "twostage_ms": two_ms, "twostage_wall_s": two_wall,
              "reference_ms": ref_ms, "host_syncs": syncs,
              "sync_round_trip_us": round_trip,
              "syncs_round_trip_ms": syncs * round_trip / 1e3,
              "edge_sets_equal": equal})
        check(equal, f"twostage {case}: edge set differs from the "
              "reference scan")
        del x, two, ref


def run_profile(label: dict, fn) -> None:
    """Trace a second call of ``fn`` with ``torch.profiler``: device time
    by kernel and the device's idle share over the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only (kernels, copies): the host-side aten ops
    # report their kernels' time again as their own device time
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  reverse=True)
    busy = sum(us for us, _, _ in rows) / 1e6
    emit({"phase": "profile", **label, "wall_s": wall,
          "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
          "device_events": sum(c for _, c, _ in rows),
          "top": [{"name": k[:90], "calls": c, "device_ms": us / 1e3}
                  for us, c, k in rows[:20]]})


def profile_all(pixels, blobs) -> None:
    from repro_torch.solver import SolveConfig, solve
    from repro_torch.solver.topk_build import build_topk_similarity

    for points, backend in ((pixels, "dense_fused"), (blobs, "dense_topk")):
        run_profile({"backend": backend, "n": points.shape[0],
                     "sweeps": 10},
                    lambda: solve(points, backend=backend, max_iterations=10,
                                  device=DEVICE))
    x = torch.from_numpy(blobs).to(DEVICE)
    cfg = SolveConfig(metric="neg_euclidean", build="twostage")
    run_profile({"build": "twostage", "metric": cfg.metric,
                 "n": x.shape[0], "k": K_TOPK},
                lambda: build_topk_similarity(x, K_TOPK, cfg))


def profile_train() -> None:
    """Trace one train step of tinyllama-1.1b at full width (lm_train's
    batch, after a first step)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import synthetic_token_stream
    from repro_torch.models import Mode, model_init
    from repro_torch.train import make_train_step
    from repro_torch.train.loop import init_train_state

    cfg = get_arch(LM_ARCH)
    model, _ = model_init(torch.Generator(DEVICE).manual_seed(0), cfg,
                          device=DEVICE)
    state = [init_train_state(model)]
    step = make_train_step(cfg, Mode("train", "dense"), lr_kwargs=TRAIN_LR)
    batch = lm_tensors({"tokens": next(synthetic_token_stream(
        cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0))}, DEVICE)

    def one():
        state[0], _ = step(state[0], batch)
    run_profile({"train": LM_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ},
                one)


# -------------------------------------------------------------- distributed
DIST_WORLD = 4           # ranks on the one card (gloo, host copies)
# sweeps of the group's runs, each compared at the same depth: the MR
# backends on the Mandrill stack (mr1d_transpose moves ~0.68 GB a rank a
# sweep through host memory)
MR_SWEEPS, TRANSPOSE_SWEEPS = 20, 3
# the default solve in the group: its sharded allgather sweeps gather
# 0.78 GB through host memory each, so it runs 3 sweeps, and so does its
# one-process comparison
DIST_SOLVE_SWEEPS = 3
# the blobs' sharded sweeps: (name, stop, exchange, sweeps, checkpoint
# every); the allgather exchange is held at 6 sweeps (the blobs do not
# converge in 50, and each sweep gathers 0.78 GB through host memory), the
# psum at 30; each checkpointed run crashes at its second save
DIST_SWEEPS = (("allgather_converged", "converged", "allgather", 6, 3),
               ("psum_fixed", "fixed", "psum", 30, 10))
DIST_CKPT = ROOT / "build" / "chip_smoke_dist_ckpt"
K_MEANS, KMEANS_ITERS = 16, 25   # the blobs' 16 centers, the default steps
KMEANS_RTOL = 1e-5       # K-means centers and inertia across summations


def digest(*tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def ckpt_timers(sync):
    """Time the sharded checkpoint runner's gathers, its writes (the
    writing rank), and a resume's read and re-padding, on this rank;
    returns the lists and a function that undoes the wrapping."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.solver import checkpointing

    times = {"gather": [], "write": [], "restore": [], "repad": []}
    saved = [(checkpointing, "all_gather"), (CheckpointManager, "save"),
             (checkpointing, "_restore"), (checkpointing, "_repad_carry")]
    originals = [getattr(o, a) for o, a in saved]

    def timed(key, fn):
        def wrapper(*args, **kw):
            sync()
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            sync()
            times[key].append((time.perf_counter() - t0) * 1e3)
            return res
        return wrapper

    for (owner, attr), fn, key in zip(saved, originals, times):
        setattr(owner, attr, timed(key, fn))

    def undo():
        for (owner, attr), fn in zip(saved, originals):
            setattr(owner, attr, fn)
    return times, undo


def dist_checkpoint(out, workers, s3k, idx, cfg, name, stop, exchange,
                    sweeps, every, sync) -> None:
    """(c): the sharded sweeps of ``name`` checkpointed every ``every``
    sweeps, uninterrupted, then crashed after the second save and resumed;
    each run's decisions, trace and this rank's state block, digested for
    the parent to hold to the plain sharded run."""
    import shutil

    from repro_torch.runtime import faultinject
    from repro_torch.solver import checkpointing

    d = DIST_CKPT / name
    ck = cfg.replace(max_iterations=sweeps, stop=stop, exchange=exchange,
                     checkpoint_every=every, checkpoint_dir=str(d))
    first = workers.axis("workers").index == 0
    times, undo = ckpt_timers(sync)
    try:
        for label, kw, rule in (
                ("checkpointed", {}, None),
                ("crashed", {}, faultinject.Rule(
                    "solver.sweep", nth=1, match={"kind": "sharded"})),
                ("resumed", {"resume_from": str(d)}, None)):
            for t in times.values():
                t.clear()
            inj = faultinject.FaultInjector()
            if rule is not None:
                inj.add(rule)
            sync()
            sent = workers.traffic.bytes_sent
            t0 = time.perf_counter()
            try:
                with faultinject.active(inj):
                    res = checkpointing.run_topk_checkpointed(
                        s3k, idx, ck.replace(**kw), mesh=workers)
            except faultinject.InjectedFault:
                res = None
            sync()
            line = out[f"{name}_{label}"] = {
                "wall_s": time.perf_counter() - t0,
                "bytes_sent": workers.traffic.bytes_sent - sent,
                "crashed": res is None,
                "boundaries": inj.hits("solver.sweep"),
                "times_ms": {k: list(v) for k, v in times.items()}}
            if res is not None:
                st, e, ns, conv, tr = res
                line.update(exemplars=digest(e), n_sweeps=ns,
                            converged=conv, trace=tr[:ns].tolist(),
                            state=digest(*st.hap))
                del st, e
                if label == "checkpointed" and first:
                    line["bytes_per_step"] = dir_bytes(d / f"step_{ns:010d}")
    finally:
        undo()
        if first:
            shutil.rmtree(d, ignore_errors=True)


def dist_rank(pixels, blobs, device: str, graph_path: str,
              init_centers) -> dict:
    """One rank of solve_distributed's group: the Mandrill similarity
    stack and the three MR backends on it; the blobs' sharded top-k build,
    the sharded default solve and the explicit sharded sweeps, plain and
    checkpointed (crashed and resumed); the sharded Borůvka on the blobs'
    graph layout; ``solve(edge_list)`` at 20,000 blobs; and MapReduce
    K-means on the blobs. Each run is read around itself: wall, bytes this
    rank sent, launches."""
    from repro_torch.baselines import kmeans_distributed
    from repro_torch.core import (
        make_preferences, pairwise_similarity, set_preferences, stack_levels,
    )
    from repro_torch.graph import EdgeList, affinity
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import factor_2d, make_mesh, make_worker_mesh
    from repro_torch.sharding import dist
    from repro_torch.solver import SolveConfig, solve, topk
    from repro_torch.solver.topk_sharded import run_topk_sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = SolveConfig(device=device)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    workers = make_worker_mesh()
    grid = make_mesh(factor_2d(dist.world_size()), ("rows", "cols"))
    out = {"rank": dist.rank(), "world": dist.world_size(),
           "transport": workers.transport,
           "device": (f"cuda:{torch.cuda.current_device()}" if on_card
                      else device), "grid": grid.shape}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def run(name, mesh, fn):
        sync()
        sent = mesh.traffic.bytes_sent
        reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out[name] = {"wall_s": time.perf_counter() - t0,
                     "bytes_sent": mesh.traffic.bytes_sent - sent,
                     "launches": launch_counts()}
        return res

    # Mandrill: S and the median preference, built on every rank
    def stack():
        s = pairwise_similarity(torch.from_numpy(pixels).to(dev))
        return s, stack_levels(set_preferences(
            s, make_preferences(s, "median")), cfg.levels)
    s, s3 = run("mandrill_similarity", workers, stack)
    out["mandrill_similarity"]["digest"] = digest(s)
    del s
    for backend, sweeps, mesh in (("mr1d_stats", MR_SWEEPS, workers),
                                  ("mr2d", MR_SWEEPS, grid),
                                  ("mr1d_transpose", TRANSPOSE_SWEEPS,
                                   workers)):
        res = run(backend, mesh, lambda: solve(
            s3, cfg, backend=backend, max_iterations=sweeps, mesh=mesh))
        out[backend].update(sweeps=sweeps, exemplars=res.exemplars,
                            n_clusters=res.n_clusters)
    del s3
    torch.cuda.empty_cache()

    # blobs: the sharded build, the sharded default solve, the sweeps
    x = torch.from_numpy(blobs).to(dev)
    sharded = cfg.replace(build="sharded", mesh=workers)
    s3k, idx = run("topk_build_sharded", workers, lambda: topk.build_from_points(
        x, K_TOPK, cfg.levels, config=sharded))
    out["topk_build_sharded"]["digest"] = digest(s3k[0, :, 1:], idx[:, 1:])
    # the default call: in a group of 4 it routes to dense_topk with the
    # sharded build (N >= 8,192) and the sharded sweep (N >= 32,768)
    res = run("topk_solve", workers, lambda: solve(
        blobs, cfg.replace(mesh=workers, max_iterations=DIST_SOLVE_SWEEPS)))
    out["topk_solve"].update(exemplars=res.exemplars, trace=res.trace,
                             n_sweeps=res.n_sweeps, backend=res.backend)
    del res
    for name, stop, exchange, sweeps, every in DIST_SWEEPS:
        st, e, ns, conv, tr = run(name, workers, lambda: run_topk_sharded(
            s3k, idx, workers, max_iterations=sweeps,
            damping=cfg.damping, stop=stop, exchange=exchange))
        out[name].update(exemplars=e[:, :x.shape[0]].cpu().numpy(),
                         exemplars_digest=digest(e), state=digest(*st.hap),
                         n_sweeps=ns, converged=conv, trace=tr[:ns])
        del st, e
        dist_checkpoint(out, workers, s3k, idx, cfg, name, stop, exchange,
                        sweeps, every, sync)
    del s3k, idx
    torch.cuda.empty_cache()

    # (a) the sharded Borůvka on the blobs' layout, loaded, never re-sorted
    t0 = time.perf_counter()
    with np.load(graph_path) as g:
        vals = torch.from_numpy(g["vals"]).to(dev)
        gidx = torch.from_numpy(g["idx"]).to(dev)
    sync()
    load_s = time.perf_counter() - t0
    obs.reset_counters("host_copies.graph_affinity")
    hist, r, conv, trace = run("graph_sharded", workers,
                               lambda: affinity.run_graph_affinity(
                                   vals, gidx, levels=cfg.levels,
                                   mesh=workers))
    out["graph_sharded"].update(
        n=vals.shape[0], load_s=load_s,
        host_reads=host_copies("graph_affinity"),
        rounds=r,
        converged=conv, trace=trace[:r].tolist(),
        padded_n=hist.shape[1], digest=digest(hist[:, :vals.shape[0]]))
    del vals, gidx, hist
    torch.cuda.empty_cache()

    # (b) the front door at 20,000 blobs: the default and sweep="sharded"
    small, _ = gaussian_blobs_n(N_ORACLE)
    el = run("graph_edges", workers, lambda: EdgeList.from_points(
        torch.from_numpy(small).to(dev), K_GRAPH))
    for sweep in ("auto", "sharded"):
        res = run(f"graph_solve_{sweep}", workers, lambda: solve(
            el, cfg.replace(mesh=workers, sweep=sweep)))
        line = out[f"graph_solve_{sweep}"]
        line.update(backend=res.backend, exemplars=digest(
            torch.from_numpy(res.exemplars)), trace=res.trace.tolist(),
            n_sweeps=res.n_sweeps, mesh_used=line["bytes_sent"] > 0)
    del el

    # (d) MapReduce K-means on the blobs, from the parent's centers
    res = run("kmeans_distributed", workers, lambda: kmeans_distributed(
        x, K_MEANS, workers, iterations=KMEANS_ITERS,
        init_centers=torch.from_numpy(init_centers).to(dev)))
    out["kmeans_distributed"].update(
        labels=res.labels.cpu().numpy() if dist.rank() == 0 else None,
        labels_digest=digest(res.labels), centers=res.centers.cpu().numpy(),
        inertia=float(res.inertia))
    return out


def run_solve_distributed(pixels, blobs, graph_one, init_centers) -> dict:
    """The MR backends, the sharded top-k path (plain and checkpointed),
    the sharded Borůvka, ``solve(edge_list)`` and MapReduce K-means on
    DIST_WORLD ranks that share the one card, against the one-process
    paths on the same card (``graph_one``: solve_graph's round loop on the
    blobs' layout); then ``python -m repro_torch.launch.cluster --workers
    4``. Returns the ranks' ``similarity`` launches by path."""
    from repro_torch.baselines import kmeans
    from repro_torch.core import comm_bytes_per_iteration
    from repro_torch.graph import EdgeList
    from repro_torch.solver import SolveConfig, solve, topk
    from repro_torch.solver.topk_sharded import comm_bytes_per_sweep

    t_phase = time.perf_counter()
    cfg = SolveConfig()
    n, nb = pixels.shape[0], blobs.shape[0]
    # -- the one-process oracles, on this card
    dense = {}
    for sweeps in (MR_SWEEPS, TRANSPOSE_SWEEPS):
        t0 = time.perf_counter()
        dense[sweeps] = solve(pixels, backend="dense_parallel",
                              max_iterations=sweeps, device=DEVICE)
        torch.cuda.synchronize()
        emit({"phase": "solve_distributed", "oracle": "dense_parallel",
              "sweeps": sweeps, "wall_s": time.perf_counter() - t0})
    from repro_torch.core import pairwise_similarity
    s_digest = digest(pairwise_similarity(
        torch.from_numpy(pixels).to(DEVICE)))
    x = torch.from_numpy(blobs).to(DEVICE)
    s3k, idx = topk.build_from_points(x, K_TOPK, cfg.levels)   # fused
    fused_digest = digest(s3k[0, :, 1:], idx[:, 1:])
    oracle = {}
    for name, stop, _, sweeps, _ in DIST_SWEEPS:
        _, e, ns, conv, tr = topk.run_topk(
            s3k, idx, max_iterations=sweeps, damping=cfg.damping, stop=stop)
        oracle[name] = (e.cpu().numpy(), ns, conv, tr[:ns])
    del s3k, idx
    topk_default = solve(blobs, max_iterations=DIST_SOLVE_SWEEPS,
                         device=DEVICE)
    small, _ = gaussian_blobs_n(N_ORACLE)
    el = EdgeList.from_points(torch.from_numpy(small).to(DEVICE), K_GRAPH)
    graph_small = solve(el, device=DEVICE)
    del el
    km = kmeans(x, K_MEANS, iterations=KMEANS_ITERS,
                init_centers=torch.from_numpy(init_centers).to(DEVICE))
    km = (km.labels.cpu().numpy(), km.centers.cpu().numpy(),
          float(km.inertia))
    del x
    torch.cuda.empty_cache()

    # -- the group
    t0 = time.perf_counter()
    ranks = dist_rank_all(pixels, blobs, init_centers)
    spawn_wall = time.perf_counter() - t0
    import shutil
    shutil.rmtree(DIST_CKPT, ignore_errors=True)
    r0 = ranks[0]
    emit({"phase": "solve_distributed", "world": r0["world"],
          "transport": r0["transport"], "grid": r0["grid"],
          "devices": [r["device"] for r in ranks], "spawn_wall_s": spawn_wall})
    on_one = "cuda:0" if DEVICE == "cuda" else DEVICE
    check(r0["world"] == DIST_WORLD and r0["transport"] == "gloo"
          and all(r["device"] == on_one for r in ranks),
          f"group: {r0['world']} ranks on {r0['transport']}")
    check(len({r["mandrill_similarity"]["digest"] for r in ranks}
              | {s_digest}) == 1,
          "the ranks' Mandrill S differ from each other or the parent's")

    def per_rank(name, key):
        return [r[name][key] for r in ranks]

    emit({"phase": "solve_distributed", "step": "Mandrill S and median",
          "wall_s": per_rank("mandrill_similarity", "wall_s"),
          "s_equal_on_every_rank_and_here": True})

    for backend in ("mr1d_stats", "mr2d", "mr1d_transpose"):
        sweeps = r0[backend]["sweeps"]
        ref = dense[sweeps]
        e = r0[backend]["exemplars"]
        mismatch = float((e != ref.exemplars).mean())
        cluster_bytes = sum(per_rank(backend, "bytes_sent"))
        model = (comm_bytes_per_iteration(
            -(-n // DIST_WORLD) * DIST_WORLD, cfg.levels, DIST_WORLD,
            backend.split("_")[1]) if backend != "mr2d" else None)
        emit({"phase": "solve_distributed", "backend": backend, "n": n,
              "sweeps": sweeps, "wall_s": per_rank(backend, "wall_s"),
              "n_clusters": r0[backend]["n_clusters"].tolist(),
              "dense_parallel_n_clusters": ref.n_clusters.tolist(),
              "exemplar_mismatch": mismatch,
              "measured_cluster_bytes_per_sweep": cluster_bytes / sweeps,
              "model_bytes_per_sweep": model,
              "launches": per_rank(backend, "launches")})
        check(all(np.array_equal(r[backend]["exemplars"], e) for r in ranks),
              f"{backend}: ranks returned other exemplars")
        check(np.array_equal(r0[backend]["n_clusters"], ref.n_clusters),
              f"{backend}: cluster counts {r0[backend]['n_clusters']} vs "
              f"dense_parallel {ref.n_clusters}")
        check(mismatch <= MAX_MISMATCH,
              f"{backend}: {mismatch:.2%} of exemplars differ")

    build = r0["topk_build_sharded"]
    emit({"phase": "solve_distributed", "step": "sharded build",
          "n": nb, "k": K_TOPK,
          "wall_s": per_rank("topk_build_sharded", "wall_s"),
          "edge_sets_equal_fused": all(
              r["topk_build_sharded"]["digest"] == fused_digest
              for r in ranks),
          "launches": per_rank("topk_build_sharded", "launches")})
    check(all(r["topk_build_sharded"]["digest"] == fused_digest
              for r in ranks),
          "sharded build: edge sets differ from the fused build's")
    sol = r0["topk_solve"]
    same = all(np.array_equal(r["topk_solve"]["exemplars"],
                              topk_default.exemplars)
               and np.array_equal(r["topk_solve"]["trace"],
                                  topk_default.trace)
               and r["topk_solve"]["n_sweeps"] == topk_default.n_sweeps
               for r in ranks)
    emit({"phase": "solve_distributed", "step": "sharded solve",
          "backend": sol["backend"], "n": nb, "sweeps": DIST_SOLVE_SWEEPS,
          "wall_s": per_rank("topk_solve", "wall_s"),
          "bytes_sent": per_rank("topk_solve", "bytes_sent"),
          "launches": per_rank("topk_solve", "launches"),
          "decisions_equal_one_process": same})
    check(sol["backend"] == "dense_topk",
          f"the default solve in a group chose {sol['backend']}")
    check(same, "sharded solve: decisions differ from the default solve")
    for name, stop, exchange, sweeps, every in DIST_SWEEPS:
        e, ns, conv, tr = oracle[name]
        got = r0[name]
        equal = all(np.array_equal(r[name]["exemplars"], e)
                    and r[name]["n_sweeps"] == ns
                    and r[name]["converged"] == conv for r in ranks)
        trace_equal = np.array_equal(got["trace"], tr)
        cluster_bytes = sum(per_rank(name, "bytes_sent"))
        emit({"phase": "solve_distributed", "step": "sharded sweeps",
              "exchange": exchange, "stop": stop, "sweeps": sweeps,
              "wall_s": per_rank(name, "wall_s"),
              "n_sweeps": got["n_sweeps"], "converged": got["converged"],
              "decisions_equal_one_process": equal,
              "trace_equal": trace_equal,
              "measured_cluster_bytes_per_sweep":
                  cluster_bytes / got["n_sweeps"],
              "model_bytes_per_sweep": comm_bytes_per_sweep(
                  nb, K_TOPK, cfg.levels, DIST_WORLD, exchange)})
        check(equal and trace_equal,
              f"sharded {exchange} {stop}: decisions differ")
        check_dist_checkpoint(ranks, name, stop, exchange, sweeps, every)

    graph_checks(ranks, graph_one, graph_small)
    kmeans_checks(ranks, km)
    launches = {
        "solve_distributed: sharded top-k solve (4 ranks)":
            [r["topk_solve"]["launches"]["similarity"] for r in ranks],
        "solve_distributed: sharded build (4 ranks)":
            [r["topk_build_sharded"]["launches"]["similarity"]
             for r in ranks]}
    launches["solve_distributed: EdgeList.from_points 20,000 (4 ranks, "
             "sharded build)"] = [r["graph_edges"]["launches"]["similarity"]
                                  for r in ranks]
    for name in ("topk_solve", "topk_build_sharded"):
        for r in ranks:
            # each rank takes the sampled median once
            counts = r[name]["launches"]
            check(counts["similarity"] > 0 and counts["median_select"] == 1
                  and sum(counts.values()) == counts["similarity"] + 1,
                  f"{name}: rank {r['rank']} launches {counts}")
    del ranks

    # -- the paper's driver
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", "--workers",
         str(DIST_WORLD), "--dataset", "aggregation", "--device", DEVICE],
        cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    emit({"phase": "solve_distributed", "step": "driver",
          "rc": proc.returncode, "seconds": time.perf_counter() - t0,
          "stdout": proc.stdout.strip().splitlines()[-5:],
          "stderr": proc.stderr.strip().splitlines()[-3:]})
    check(proc.returncode == 0, "launch.cluster --workers 4 failed")
    emit({"phase": "solve_distributed", "step": "done",
          "seconds": time.perf_counter() - t_phase})
    return launches


def check_dist_checkpoint(ranks, name, stop, exchange, sweeps,
                          every) -> None:
    """(c): every rank's checkpointed, crashed and resumed runs against its
    plain sharded run of the same exchange and depth: decisions, trace,
    sweep count, flag and its state block bit-equal; the crash after the
    second save; the resumed run fired the remaining boundaries only."""
    r0 = ranks[0]
    plain_keys = ("exemplars_digest", "n_sweeps", "converged", "state")
    equal = {}
    for label in ("checkpointed", "resumed"):
        equal[label] = all(
            [r[f"{name}_{label}"][k] for k in ("exemplars", "n_sweeps",
                                                "converged", "state")]
            == [r[name][k] for k in plain_keys]
            and r[f"{name}_{label}"]["trace"] == r[name]["trace"].tolist()
            for r in ranks)
    crashed = r0[f"{name}_crashed"]
    resumed = r0[f"{name}_resumed"]
    whole = r0[f"{name}_checkpointed"]
    saves = whole["boundaries"]
    # seven gathers a boundary (six state fields, the exemplars), then the
    # result's exemplars once
    gather_ms = [[sum(r[f"{name}_checkpointed"]["times_ms"]["gather"][
        7 * i:7 * i + 7]) for i in range(saves)] for r in ranks]
    emit({"phase": "solve_distributed", "step": "checkpointed sharded sweeps",
          "exchange": exchange, "stop": stop, "sweeps": sweeps,
          "every": every, "n_sweeps": whole["n_sweeps"],
          "converged": whole["converged"],
          "wall_s": {label: [r[f"{name}_{label}"]["wall_s"] for r in ranks]
                     for label in ("checkpointed", "crashed", "resumed")},
          "plain_wall_s": [r[name]["wall_s"] for r in ranks],
          "bytes_sent": {label: [r[f"{name}_{label}"]["bytes_sent"]
                                 for r in ranks]
                         for label in ("checkpointed", "crashed", "resumed")},
          "gather_ms_a_save": gather_ms,
          "write_ms_a_save": whole["times_ms"]["write"],
          "bytes_per_step": whole["bytes_per_step"],
          "resume_ms": {"read": [r[f"{name}_resumed"]["times_ms"]["restore"]
                                 for r in ranks],
                        "repad": [r[f"{name}_resumed"]["times_ms"]["repad"]
                                  for r in ranks]},
          "boundaries": {"checkpointed": saves,
                         "crashed": crashed["boundaries"],
                         "resumed": resumed["boundaries"]},
          "bit_equal_to_plain": equal})
    check(all(r[f"{name}_crashed"]["crashed"] for r in ranks)
          and crashed["boundaries"] == 2,
          f"{name}: the injected crash did not fire at the second save")
    check(saves == -(-whole["n_sweeps"] // every)
          and len(whole["times_ms"]["gather"]) == 7 * saves + 1
          and len(whole["times_ms"]["write"]) == saves
          and resumed["boundaries"] == saves - 2,
          f"{name}: {saves} boundaries, {resumed['boundaries']} resumed")
    check(all(equal.values()),
          f"{name}: checkpointed sharded runs differ from the plain run: "
          f"{equal}")


def graph_checks(ranks, graph_one, graph_small) -> None:
    """(a) and (b): the sharded Borůvka at the blobs against the card's
    one-process loop; ``solve(edge_list)`` in the group at 20,000 blobs,
    by default and with ``sweep="sharded"``, against one process."""
    g = [r["graph_sharded"] for r in ranks]
    same = all(x["digest"] == graph_one["digest"]
               and x["rounds"] == graph_one["rounds"]
               and x["converged"] == graph_one["converged"]
               and x["trace"] == graph_one["trace"] for x in g)
    emit({"phase": "solve_distributed", "step": "sharded Borůvka",
          "n": g[0]["n"], "padded_n": g[0]["padded_n"], "levels":
          graph_one["levels"], "rounds": g[0]["rounds"],
          "host_reads": [x["host_reads"] for x in g],
          "load_s": [x["load_s"] for x in g],
          "wall_s": [x["wall_s"] for x in g],
          "one_process_wall_s": graph_one["wall_s"],
          "bytes_sent": [x["bytes_sent"] for x in g],
          "launches": [x["launches"] for x in g],
          "labels_rounds_trace_equal_one_process": same})
    check(same, "sharded Borůvka differs from the one-process loop")
    check(all(x["host_reads"] == x["rounds"] for x in g),
          "sharded Borůvka: not one host read a round")
    check(all(not any(x["launches"].values()) for x in g),
          "sharded Borůvka launched a kernel")
    one = graph_small
    for sweep in ("auto", "sharded"):
        lines = [r[f"graph_solve_{sweep}"] for r in ranks]
        same = all(x["exemplars"] == digest(torch.from_numpy(one.exemplars))
                   and x["trace"] == one.trace.tolist()
                   and x["n_sweeps"] == one.n_sweeps for x in lines)
        emit({"phase": "solve_distributed", "step": "solve(edge_list)",
              "n": N_ORACLE, "sweep": sweep, "route": lines[0]["backend"],
              "mesh_used": [x["mesh_used"] for x in lines],
              "wall_s": [x["wall_s"] for x in lines],
              "bytes_sent": [x["bytes_sent"] for x in lines],
              "edge_list_wall_s": [r["graph_edges"]["wall_s"] for r in ranks],
              "rounds": lines[0]["n_sweeps"],
              "decisions_equal_one_process": same})
        check(all(x["backend"] == "graph_affinity" for x in lines),
              f"solve(edge_list) in the group chose {lines[0]['backend']}")
        check(all(x["mesh_used"] == (sweep == "sharded") for x in lines),
              f"solve(edge_list, sweep={sweep!r}): mesh used "
              f"{[x['mesh_used'] for x in lines]}")
        check(same, f"solve(edge_list, sweep={sweep!r}) in the group "
                    "differs from one process")
    # in a group of 4 the edge list's build (N >= 8,192) is the sharded
    # reference scan, whose tiles the similarity kernel computes
    counts = [r["graph_edges"]["launches"] for r in ranks]
    check(all(c["similarity"] > 0 and sum(c.values()) == c["similarity"]
              for c in counts),
          f"EdgeList.from_points in the group: launches {counts}")


def kmeans_checks(ranks, km) -> None:
    """(d): MapReduce K-means in the group against one-process K-means on
    the card from the same centers: labels equal, centers and inertia
    within KMEANS_RTOL (the ranks' partial sums associate otherwise)."""
    labels, centers, inertia = km
    lines = [r["kmeans_distributed"] for r in ranks]
    scale = float(np.abs(centers).max())
    center_err = max(float(np.abs(x["centers"] - centers).max())
                     for x in lines)
    inertia_err = max(abs(x["inertia"] - inertia) for x in lines)
    same = (np.array_equal(lines[0]["labels"], labels)
            and len({x["labels_digest"] for x in lines}) == 1)
    emit({"phase": "solve_distributed", "step": "kmeans_distributed",
          "n": len(labels), "k": K_MEANS, "iterations": KMEANS_ITERS,
          "wall_s": [x["wall_s"] for x in lines],
          "bytes_sent": [x["bytes_sent"] for x in lines],
          "labels_equal_one_process": same,
          "centers_max_rel_err": center_err / scale,
          "inertia_rel_err": inertia_err / abs(inertia),
          "rtol": KMEANS_RTOL})
    check(same, "kmeans_distributed: labels differ from one process")
    check(center_err <= KMEANS_RTOL * scale
          and inertia_err <= KMEANS_RTOL * abs(inertia),
          f"kmeans_distributed: centers {center_err / scale:.2e}, inertia "
          f"{inertia_err / abs(inertia):.2e} relative")


# ---------------------------------------------------------------- baselines
CURATE_BASES, CURATE_COPIES, CURATE_D = 512, 8, 1_024
# the bases' scale: S's rounding (which cuBLAS and the CPU's BLAS do
# differently, ROADMAP C2) grows with |x|^2, the near-copies' spread with
# the noise; at 0.25 the batch is as well-conditioned as
# tests/test_pipeline.py's (within-copy spread ~500x S's rounding); at 1.0
# the card and the CPU kept other copies in a few groups (PERF.md, ROADMAP
# C9), and that batch is checked for one kept copy of every base
CURATE_SCALE, CURATE_DRIFT_SCALE, CURATE_NOISE = 0.25, 1.0, 0.02
# qwen3-moe-235b-a22b's router (configs/registry.py: 128 experts), over
# 4,096 tokens
N_EXPERTS, N_TOKENS = 128, 4_096


def timed_sync(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def run_baselines(blobs, truth, init_centers) -> dict:
    """(e) K-means and (f) HK-Means on the 200,000 blobs, (g) the paper's
    Fig 5.1 comparison, (h) the curation hook and (i) the expert-affinity
    hook, each on the card beside the CPU port. Returns the ``topk_build``
    launches of the Fig 5.1 top-k solves."""
    from repro_torch.baselines import hierarchical_kmeans, kmeans
    from repro_torch.baselines.canopy import auto_thresholds, canopy_centers
    from repro_torch.core import link_hierarchy, purity
    from repro_torch.core.expert_affinity import cluster_experts
    from repro_torch.data import aggregation_like, gaussian_blobs, two_moons
    from repro_torch.data.pipeline import hap_curate_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solver import solve

    t_phase = time.perf_counter()
    # (e) K-means from the seed-0 draw, on the card and on the CPU
    x = torch.from_numpy(blobs).to(DEVICE)
    init = torch.from_numpy(init_centers)
    run = lambda pts: kmeans(pts, K_MEANS, iterations=KMEANS_ITERS,
                             init_centers=init.to(pts.device))
    timed_sync(lambda: run(x))
    card, card_s = timed_sync(lambda: run(x))
    t0 = time.perf_counter()
    cpu = run(torch.from_numpy(blobs))
    cpu_s = time.perf_counter() - t0
    apart = float((card.labels.cpu() != cpu.labels).float().mean())
    emit({"phase": "baselines", "method": "kmeans", "n": len(blobs),
          "k": K_MEANS, "iterations": KMEANS_ITERS, "init": "seed 0",
          "wall_s": card_s, "cpu_wall_s": cpu_s,
          "purity": purity(card.labels.cpu().numpy(), truth),
          "inertia": float(card.inertia), "cpu_inertia": float(cpu.inertia),
          "labels_apart_from_cpu": apart})
    check(apart <= MAX_MISMATCH,
          f"kmeans: {apart:.2%} of labels differ from the CPU's")

    # (f) HK-Means: canopy on the host, K-means on the card
    t0 = time.perf_counter()
    seeds = canopy_centers(blobs, *auto_thresholds(blobs, 0), 0)
    canopy_s = time.perf_counter() - t0
    hk, hk_s = timed_sync(lambda: hierarchical_kmeans(blobs, 3, branch=3,
                                                device=DEVICE))
    top = kmeans(x, max(2, len(seeds)), iterations=KMEANS_ITERS,
                 init_centers=torch.from_numpy(seeds).to(DEVICE))
    nested = all(len(np.unique(coarse[fine == c])) == 1
                 for fine, coarse in zip(hk.labels[:-1], hk.labels[1:])
                 for c in np.unique(fine))
    emit({"phase": "baselines", "method": "hierarchical_kmeans",
          "n": len(blobs), "levels": 3, "branch": 3, "wall_s": hk_s,
          "canopy_host_s": canopy_s, "kmeans_and_rest_s": hk_s - canopy_s,
          "canopies": len(seeds), "n_clusters": hk.n_clusters.tolist(),
          "purity": [purity(l, truth) for l in hk.labels],
          "levels_nest": nested})
    check(nested, "HK-Means: a finer cluster straddles two coarser ones")
    check(np.array_equal(hk.labels[-1], top.labels.cpu().numpy()),
          "HK-Means: top level is not K-means from the canopy seeds")
    del x, card, cpu, top

    # (g) Fig 5.1: bench_purity.py's methods on its DATASETS
    launches = {}
    for name, (pts, y) in (
            ("aggregation", aggregation_like()),
            ("blobs", gaussian_blobs(n=600, k=6, seed=2, spread=0.5)),
            ("moons", two_moons(n=400, seed=3))):
        rows = {}
        for where in (DEVICE, "cpu"):
            kw = dict(levels=3, max_iterations=40, damping=0.7,
                      preference="median", device=where)
            reset_launch_counts()
            hap, hap_s = timed_sync(lambda: solve(
                pts, backend="dense_parallel", **kw))
            top, top_s = timed_sync(lambda: solve(
                pts, backend="dense_topk", k=32, **kw))
            hkm, hk_s = timed_sync(lambda: hierarchical_kmeans(
                pts, 3, branch=3, device=where))
            if where == DEVICE:
                path = f"baselines: Fig 5.1 dense_topk k = 32, {name}"
                launches[path] = launch_counts()["topk_build"]
                check(launches[path] == 1,
                      f"{path}: topk_build launched {launches[path]}")
            rows[where] = {"hap": hap, "topk": top, "hk": hkm,
                           "s": [hap_s, top_s, hk_s]}
        table = {}
        for where, r in rows.items():
            hier = {m: link_hierarchy(r[m].exemplars) for m in ("hap", "topk")}
            table[where] = {
                m: [[purity(hier[m].labels[l], y), int(hier[m].n_clusters[l])]
                    for l in range(3)] for m in hier}
            table[where]["hk"] = [[purity(r["hk"].labels[l], y),
                                   int(r["hk"].n_clusters[l])]
                                  for l in range(3)]
            table[where]["wall_s"] = dict(zip(("hap", "topk", "hk"), r["s"]))
        card, cpu = rows[DEVICE], rows["cpu"]
        same = {m: bool(np.array_equal(card[m].exemplars, cpu[m].exemplars))
                for m in ("hap", "topk")}
        same["hk_top"] = bool(np.array_equal(card["hk"].labels[-1],
                                             cpu["hk"].labels[-1]))
        emit({"phase": "baselines", "step": "Fig 5.1", "dataset": name,
              "n": len(pts), "purity_and_clusters_by_level":
              {"card": table[DEVICE], "cpu": table["cpu"]},
              "equal_on_card_and_cpu": same})
        check(all(same.values()),
              f"Fig 5.1 {name}: card and CPU differ: {same}")

    # (h) curation: 512 seeded bases x 8 near-copies, width 1,024, at two
    # base scales: at CURATE_SCALE the kept indices equal the CPU's; at
    # CURATE_DRIFT_SCALE (ROADMAP C9) the card and the CPU may keep another
    # near-copy of a base, so there each keeps exactly one copy of every base
    for scale in (CURATE_SCALE, CURATE_DRIFT_SCALE):
        rng = np.random.default_rng(0)
        base = scale * rng.standard_normal(
            (CURATE_BASES, CURATE_D)).astype(np.float32)
        batch = (np.repeat(base, CURATE_COPIES, axis=0)
                 + CURATE_NOISE * rng.standard_normal(
                     (CURATE_BASES * CURATE_COPIES, CURATE_D)).astype(
                         np.float32))
        hap_curate_batch(batch, device=DEVICE)
        keep, keep_s = timed_sync(lambda: hap_curate_batch(batch,
                                                           device=DEVICE))
        t0 = time.perf_counter()
        keep_cpu = hap_curate_batch(batch, device="cpu")
        cpu_s = time.perf_counter() - t0
        same = bool(np.array_equal(keep, keep_cpu))
        one_each = {where: len(k) == CURATE_BASES and bool(np.array_equal(
            k // CURATE_COPIES, np.arange(CURATE_BASES)))
            for where, k in (("card", keep), ("cpu", keep_cpu))}
        emit({"phase": "baselines", "step": "hap_curate_batch",
              "n": len(batch), "d": CURATE_D, "base_scale": scale,
              "noise": CURATE_NOISE, "kept": len(keep),
              "kept_cpu": len(keep_cpu),
              "groups_kept": len(np.unique(keep // CURATE_COPIES)),
              "one_per_base": one_each,
              "kept_apart_from_cpu": len(set(keep) ^ set(keep_cpu)),
              "bases_kept_by_another_copy": int(
                  (keep != keep_cpu).sum()) if len(keep) == len(keep_cpu)
              else None,
              "wall_s": keep_s, "cpu_wall_s": cpu_s, "kept_equal_cpu": same})
        if scale == CURATE_SCALE:
            check(same, "hap_curate_batch: the card kept other indices")
        else:
            check(all(one_each.values()),
                  f"hap_curate_batch at base scale {scale}: not one kept "
                  f"copy of every base on the card and the CPU: {one_each}")

    # (i) expert affinity at 128 experts: planted co-activated pairs
    rng = np.random.default_rng(1)
    probs = rng.random((N_TOKENS, N_EXPERTS)).astype(np.float32) * 0.05
    hot = rng.integers(0, N_EXPERTS // 2, N_TOKENS)
    probs[np.arange(N_TOKENS), 2 * hot] += 0.5
    probs[np.arange(N_TOKENS), 2 * hot + 1] += 0.5
    probs /= probs.sum(1, keepdims=True)
    cluster_experts(probs, device=DEVICE)
    res, res_s = timed_sync(lambda: cluster_experts(probs, device=DEVICE))
    t0 = time.perf_counter()
    res_cpu = cluster_experts(probs, device="cpu")
    cpu_s = time.perf_counter() - t0
    pairs = bool((res.labels[0::2] == res.labels[1::2]).all())
    same = bool(np.array_equal(res.labels, res_cpu.labels))
    emit({"phase": "baselines", "step": "cluster_experts",
          "experts": N_EXPERTS, "tokens": N_TOKENS,
          "n_clusters": res.n_clusters, "redundancy": res.redundancy,
          "wall_s": res_s, "cpu_wall_s": cpu_s,
          "planted_pairs_share_a_cluster": pairs, "labels_equal_cpu": same})
    check(same and pairs, "cluster_experts: card differs from the CPU, or "
                          "a planted pair was split")
    emit({"phase": "baselines", "step": "done",
          "seconds": time.perf_counter() - t_phase})
    return launches


def dist_rank_all(pixels, blobs, init_centers) -> list:
    from repro_torch.sharding import dist
    return dist.spawn(dist_rank, DIST_WORLD, device=DEVICE,
                      args=(pixels, blobs, DEVICE, str(GRAPH_LAYOUT),
                            init_centers))


# ---------------------------------------------------------------- lm_serve
LM_ARCH = "tinyllama-1.1b"   # configs/registry.py: 22 layers, d_model 2,048
LM_BATCH, LM_PROMPT, LM_STEPS = 8, 512, 64
LM_MAX_LEN = LM_PROMPT + LM_STEPS + 8   # launch/serve.py's headroom
LM_SLOTS, LM_REQUESTS = 8, 16
LM_MIN_PROMPT, LM_MIN_STEPS = 32, 16    # the requests' mixed lengths
LM_ATOL = 2e-2          # tests/test_models_smoke.py's decode bar
LM_REF_SHARE = 1.5      # bfloat16: within 1.5x the CPU's own error
LM_F32_ATOL = 1e-4      # float32 compute: card vs CPU, decode vs forward
# bfloat16 decode against the forward at 22 layers and 512 tokens: 1.5x
# the reference's own largest gap there, 0.046875 on the CPU
# (tools/lm_decode_drift.py --seq 512); the 2e-2 bar above was set on
# 2-layer configs
LM_DECODE_BF16_BAR = LM_REF_SHARE * 0.046875
KV_WINDOW = 512


@contextlib.contextmanager
def float32_compute():
    """The port's model modules at COMPUTE_DTYPE float32 for the duration:
    the exact-arithmetic run that sizes the bfloat16 rounding a tolerance
    allows for (tests/_torch_lm.py does the same on the CPU)."""
    saved = [(m, m.COMPUTE_DTYPE) for name, m in list(sys.modules.items())
             if name.startswith("repro_torch.models")
             and hasattr(m, "COMPUTE_DTYPE")]
    for m, _ in saved:
        m.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        for m, value in saved:
            m.COMPUTE_DTYPE = value


def lm_tensors(inputs: dict, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}


@torch.inference_mode()
def lm_logits(model, cfg, inputs: dict, dev) -> tuple[np.ndarray, np.ndarray]:
    """(the forward's logits (B, S, V), the logits of decoding the last
    token after a prefill of the others (B, V)) on ``dev``, float32 numpy,
    the padded vocab dropped."""
    from repro_torch.models import Mode, model_apply, model_state_init

    x = lm_tensors(inputs, dev)
    full, _, _ = model_apply(model, cfg, x, Mode("train", "dense"))
    b, s = x["tokens"].shape
    prefix = cfg.img_tokens if cfg.family == "vlm" else 0
    pre = dict(x, tokens=x["tokens"][:, :-1],
               positions=torch.arange(s - 1 + prefix, device=dev)[None]
               .expand(b, -1))
    st = model_state_init(cfg, b, s + prefix, device=dev)
    _, st, _ = model_apply(model, cfg, pre, Mode("prefill", "dense"), st)
    dec = {"tokens": x["tokens"][:, -1:],
           "positions": torch.full((b, 1), s - 1 + prefix, device=dev)}
    last, _, _ = model_apply(model, cfg, dec, Mode("decode", "dense"), st)
    return (full.float().cpu().numpy()[..., :cfg.vocab],
            last[:, 0].float().cpu().numpy()[..., :cfg.vocab])


@torch.inference_mode()
def lm_step_logits(model, cfg, prompts, tokens, max_len) -> np.ndarray:
    """The engine's logits before each of ``tokens`` (B, T) when it decodes
    them after ``prompts`` (B, S): (B, T, V), float32 numpy."""
    from repro_torch.models import model_state_init
    from repro_torch.serve import make_decode_step, make_prefill_step

    dev = prompts.device
    b, s = prompts.shape
    states = model_state_init(cfg, b, max_len, layout="list", device=dev)
    logits, states = make_prefill_step(cfg, s)(
        model, {"tokens": prompts,
                "positions": torch.arange(s, device=dev)[None].expand(b, s)},
        states)
    out = [logits]
    decode = make_decode_step(cfg)
    for i in range(tokens.shape[1] - 1):
        logits, states = decode(
            model, {"tokens": tokens[:, i:i + 1],
                    "positions": torch.full((b, 1), s + i, device=dev)},
            states)
        out.append(logits)
    return torch.stack(out, 1).float().cpu().numpy()[..., :cfg.vocab]


def under_margin(logits: np.ndarray, tol: float) -> np.ndarray:
    """Where the top-2 margin is within 2 tol: an argmax the tolerance
    allows to flip."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] <= 2 * tol


def moe_routing(model, cfg, inputs: dict, dev) -> list:
    """Each MoE layer's input in a forward on ``dev`` (forward pre-hooks)."""
    from repro_torch.models import Mode, model_apply
    from repro_torch.models.layers.moe import MoE

    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0].detach())))
        for m in model.modules() if isinstance(m, MoE)]
    try:
        with torch.inference_mode():
            model_apply(model, cfg, lm_tensors(inputs, dev),
                        Mode("train", "dense"))
    finally:
        for h in hooks:
            h.remove()
    return seen


def route(mod, x, cfg):
    """(expert of each choice, kept) of one MoE layer on ``x``, on x's
    device."""
    from repro_torch.models.layers.moe import _route_and_dispatch, capacity

    e = mod.router.shape[-1]
    t = x.shape[0] * x.shape[1]
    cap = capacity(t, cfg.top_k, e, cfg.capacity_factor)
    with torch.inference_mode():
        _, (inv, _, _, flat_e) = _route_and_dispatch(
            x.reshape(t, -1), mod.router, cfg.top_k, 0, e, cap)
    return flat_e.cpu().numpy(), (inv != e * cap).cpu().numpy()


def lm_smoke_on_card_and_cpu(name: str) -> dict:
    """(c) one ``-smoke`` architecture: the same parameters and inputs on
    the card and on the CPU; in float32 compute the logits within
    LM_F32_ATOL of each other (what the card could get wrong: TF32, a lost
    cast), and as configured within max(LM_ATOL, LM_REF_SHARE x the CPU's
    own bfloat16 error against its float32 run)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model_init

    cfg = get_arch(name + "-smoke")
    model, _ = model_init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    card = copy.deepcopy(model).to(DEVICE)
    rng = np.random.default_rng(0)
    inputs = {"tokens": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)}
    if cfg.family == "audio":
        inputs["frames"] = (0.02 * rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model))).astype(np.float32)
    if cfg.family == "vlm":
        inputs["img_embeds"] = (0.02 * rng.standard_normal(
            (2, cfg.img_tokens, cfg.d_model))).astype(np.float32)
    full, last = lm_logits(card, cfg, inputs, DEVICE)
    full_cpu, last_cpu = lm_logits(model, cfg, inputs, "cpu")
    with float32_compute():
        card32, card_last32 = lm_logits(card, cfg, inputs, DEVICE)
        full32, last32 = lm_logits(model, cfg, inputs, "cpu")
    tol = max(LM_ATOL, LM_REF_SHARE * float(np.abs(full_cpu - full32).max()))
    err = float(np.abs(full - full_cpu).max())
    err_dec = float(np.abs(last - last_cpu).max())
    err32 = float(max(np.abs(card32 - full32).max(),
                      np.abs(card_last32 - last32).max()))
    clear = ~under_margin(full_cpu, tol)
    flips = int(((full.argmax(-1) != full_cpu.argmax(-1)) & clear).sum())
    row = {"arch": cfg.name, "tol": tol,
           "cpu_bf16_err": float(np.abs(full_cpu - full32).max()),
           "median_abs_logit": float(np.median(np.abs(full_cpu))),
           "forward_err": err, "decode_err": err_dec,
           "f32_err": err32, "f32_tol": LM_F32_ATOL,
           "finite": bool(np.isfinite(full).all() and np.isfinite(last).all()),
           "positions": int(clear.size),
           "under_margin": int((~clear).sum()), "clear_argmax_flips": flips}
    if cfg.n_experts:
        same_in = own = 0
        layers = list(zip(moe_routing(card, cfg, inputs, DEVICE),
                          moe_routing(model, cfg, inputs, "cpu")))
        for (mod_card, x_card), (mod_cpu, x_cpu) in layers:
            on_card = route(mod_card, x_card, cfg)
            same_in += not all(np.array_equal(a, b) for a, b in zip(
                on_card, route(mod_cpu, x_card.cpu(), cfg)))
            own += not all(np.array_equal(a, b) for a, b in zip(
                on_card, route(mod_cpu, x_cpu, cfg)))
        row.update({"moe_layers": len(layers),
                    "routing_differs_same_input": same_in,
                    "routing_differs_own_inputs": own})
        check(same_in == 0 and own == 0,
              f"lm_serve {cfg.name}: routing differs on the card: {row}")
    check(row["finite"] and err32 <= LM_F32_ATOL and err <= tol
          and err_dec <= tol and flips == 0,
          f"lm_serve {cfg.name}: the card is off the CPU: {row}")
    return row


def run_lm_serve(smi: str) -> dict:
    """(a) tinyllama-1.1b at full width and depth served on the card, (b)
    continuous batching at that width, (c) the card against the CPU on the
    ten reduced architectures and on tinyllama cut to 2 layers, (d) the
    exemplar KV cache on a layer of (a)'s cache, (e) the serving driver.
    Returns the five kernels' launches over the phase (all 0: the models
    call none)."""
    from repro_torch.configs import arch_names, get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Mode, model_apply, model_init
    from repro_torch.models import model_state_init
    from repro_torch.serve import (
        ContinuousBatchingEngine, ServeEngine, make_prefill_step,
    )
    from repro_torch.serve.kvcache import exemplar_compress_cache

    t_phase = time.perf_counter()
    reset_launch_counts()
    # (a) full width, full depth
    cfg = get_arch(LM_ARCH)
    gen = torch.Generator(DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    model, _ = model_init(gen, cfg, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=DEVICE, dtype=torch.int32)
    engine = ServeEngine(cfg, model, max_len=LM_MAX_LEN)
    engine.generate(prompts[:, :32], steps=2)                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    out, gen_s = timed_sync(lambda: engine.generate(prompts, steps=LM_STEPS))
    peak = torch.cuda.max_memory_allocated()
    again = engine.generate(prompts, steps=LM_STEPS)
    states = model_state_init(cfg, LM_BATCH, LM_MAX_LEN, layout="list",
                              device=DEVICE)
    prefill = make_prefill_step(cfg, LM_PROMPT)
    pos = torch.arange(LM_PROMPT, device=DEVICE)[None].expand(LM_BATCH, -1)
    with torch.inference_mode():
        (logits, states), pre_s = timed_sync(lambda: prefill(
            model, {"tokens": prompts, "positions": pos}, states))
    decode_ms = (gen_s - pre_s) / LM_STEPS * 1e3
    # decode at the last position against the full forward, on 2 rows, in
    # float32 and in bfloat16 (where the reference itself misses its 2e-2
    # bar at this depth: LM_DECODE_BF16_BAR)
    def decode_and_forward():
        with torch.inference_mode():
            x2 = prompts[:2]
            full, _, _ = model_apply(model, cfg, {"tokens": x2},
                                     Mode("train", "dense"))
            st = model_state_init(cfg, 2, LM_PROMPT, device=DEVICE)
            _, st, _ = model_apply(model, cfg, {"tokens": x2[:, :-1],
                                                "positions": pos[:2, :-1]},
                                   Mode("prefill", "dense"), st)
            dec, _, _ = model_apply(model, cfg, {
                "tokens": x2[:, -1:],
                "positions": torch.full((2, 1), LM_PROMPT - 1,
                                        device=DEVICE)},
                Mode("decode", "dense"), st)
        return dec[:, 0].float(), full[:, -1].float()

    got, want = decode_and_forward()
    with float32_compute():
        got32, want32 = decode_and_forward()
    dec_err = float((got - want).abs().max())
    dec_err32 = float((got32 - want32).abs().max())
    fwd_bf16_err = float((want - want32).abs().max())
    dec_ok = bool(torch.allclose(got32, want32, atol=LM_F32_ATOL, rtol=0)
                  and (torch.allclose(got, want, atol=LM_ATOL, rtol=LM_ATOL)
                       or dec_err <= LM_DECODE_BF16_BAR))
    row = {"phase": "lm_serve", "step": "full width", "arch": LM_ARCH,
           "card": smi, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "init_s": init_s, "batch": LM_BATCH,
           "prompt": LM_PROMPT, "steps": LM_STEPS,
           "prefill_ms": pre_s * 1e3,
           "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / pre_s,
           "generate_s": gen_s, "decode_ms_per_step": decode_ms,
           "tokens_per_s": LM_BATCH * LM_STEPS / gen_s,
           "decode_tokens_per_s": LM_BATCH * 1e3 / decode_ms,
           "peak_mem_gb": peak / 1e9,
           "peak_over_params_gb": (peak - base_mem) / 1e9,
           "logits_finite": bool(torch.isfinite(logits).all()),
           "second_call_equal": bool(torch.equal(out, again)),
           "decode_vs_forward_max_err": dec_err,
           "decode_vs_forward_max_err_f32": dec_err32,
           "forward_bf16_vs_f32_max_err": fwd_bf16_err,
           "decode_bf16_bar": LM_DECODE_BF16_BAR,
           "decode_vs_forward_ok": dec_ok}
    emit(row)
    check(row["logits_finite"] and row["second_call_equal"] and dec_ok,
          f"lm_serve full width: {row}")

    # (d) the exemplar KV cache on layer 0's cache of the prefill above
    cache = states["units"]["0_attn"][0]
    k0 = cache.k[0, :KV_WINDOW].float().reshape(KV_WINDOW, -1).cpu()
    s0 = -torch.cdist(k0, k0).square()
    pref = float(s0[~torch.eye(KV_WINDOW, dtype=torch.bool)].median())
    exemplar_compress_cache(cache, window=KV_WINDOW, preference=pref)
    (kv, stats), kv_s = timed_sync(lambda: exemplar_compress_cache(
        cache, window=KV_WINDOW, preference=pref))
    cpu_cache = type(cache)(*(t.cpu() for t in cache))
    t0 = time.perf_counter()
    kv_cpu, stats_cpu = exemplar_compress_cache(cpu_cache, window=KV_WINDOW,
                                                preference=pref)
    kv_cpu_s = time.perf_counter() - t0
    keep = kv.pos[:, :KV_WINDOW].cpu() >= 0
    keep_cpu = kv_cpu.pos[:, :KV_WINDOW] >= 0
    apart = (keep != keep_cpu).sum(1)
    row = {"phase": "lm_serve", "step": "exemplar kv cache",
           "layer": "units.0_attn.0", "rows": LM_BATCH, "window": KV_WINDOW,
           "kv_heads": cfg.n_kv, "head_dim": cfg.resolved_head_dim,
           "preference": pref, "kept": stats.kept.tolist(),
           "kept_cpu": stats_cpu.kept.tolist(),
           "slots_apart_by_row": apart.tolist(),
           "masks_equal": bool(torch.equal(keep, keep_cpu)),
           "wall_s": kv_s, "cpu_wall_s": kv_cpu_s}
    emit(row)
    check(row["masks_equal"] and row["kept"] == row["kept_cpu"],
          f"lm_serve exemplar cache: card and CPU keep apart: {row}")
    del states, cache, kv, logits

    # (b) continuous batching at the same width
    rng = np.random.default_rng(0)
    lengths = rng.integers(LM_MIN_PROMPT, LM_PROMPT + 1, LM_REQUESTS)
    budgets = rng.integers(LM_MIN_STEPS, LM_STEPS + 1, LM_REQUESTS)
    reqs = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lengths]
    cb = ContinuousBatchingEngine(cfg, model, slots=LM_SLOTS,
                                  max_len=LM_MAX_LEN)
    rids = [cb.submit(r, max_new=int(m)) for r, m in zip(reqs, budgets)]
    steps = 0
    t0 = time.perf_counter()
    while cb.queue or any(s.request_id is not None for s in cb.slots):
        cb.step()
        steps += 1
    torch.cuda.synchronize()
    cb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    isolated = [engine.generate(r[None], steps=int(m)).cpu().numpy()[0]
                for r, m in zip(reqs, budgets)]
    iso_s = time.perf_counter() - t0
    equal = [bool(np.array_equal(cb.finished[rid], want))
             for rid, want in zip(rids, isolated)]
    first_apart = [int(np.flatnonzero(cb.finished[rid] != want)[0])
                   if not ok else None
                   for rid, want, ok in zip(rids, isolated, equal)]
    row = {"phase": "lm_serve", "step": "continuous batching",
           "slots": LM_SLOTS, "requests": LM_REQUESTS,
           "prompt_lengths": lengths.tolist(), "budgets": budgets.tolist(),
           "decode_steps": steps, "wall_s": cb_s,
           "tokens_per_s": int(budgets.sum()) / cb_s,
           "isolated_wall_s": iso_s, "equal_isolated": sum(equal),
           "first_step_apart": first_apart}
    emit(row)
    check(all(equal), f"lm_serve continuous batching: {row}")
    del cb, engine, model
    torch.cuda.empty_cache()

    # (c) the card against the CPU: the ten reduced architectures
    rows = [lm_smoke_on_card_and_cpu(name) for name in arch_names()]
    emit({"phase": "lm_serve", "step": "card vs cpu, -smoke",
          "archs": rows})
    # ... and tinyllama at full width cut to 2 layers
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    model2, _ = model_init(torch.Generator(DEVICE).manual_seed(0), cfg2,
                           device=DEVICE)
    cpu2 = copy.deepcopy(model2).cpu()
    p2 = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 16)).astype(
        np.int32))
    tok = ServeEngine(cfg2, model2, max_len=32).generate(
        p2.to(DEVICE), steps=4).cpu()
    tok_cpu = ServeEngine(cfg2, cpu2, max_len=32).generate(p2, steps=4)
    lg = lm_step_logits(model2, cfg2, p2.to(DEVICE), tok_cpu.to(DEVICE), 32)
    lg_cpu = lm_step_logits(cpu2, cfg2, p2, tok_cpu, 32)
    with float32_compute():
        lg_card32 = lm_step_logits(model2, cfg2, p2.to(DEVICE),
                                   tok_cpu.to(DEVICE), 32)
        lg32 = lm_step_logits(cpu2, cfg2, p2, tok_cpu, 32)
    tol = max(LM_ATOL, LM_REF_SHARE * float(np.abs(lg_cpu - lg32).max()))
    under = under_margin(lg_cpu, tol)[0]
    stop = int(np.flatnonzero(under)[0]) if under.any() else 4
    row = {"phase": "lm_serve", "step": "card vs cpu, 2 layers full width",
           "arch": cfg2.name, "prompt": 16, "steps": 4, "tol": tol,
           "cpu_bf16_err": float(np.abs(lg_cpu - lg32).max()),
           "median_abs_logit": float(np.median(np.abs(lg_cpu))),
           "logits_err": float(np.abs(lg - lg_cpu).max()),
           "f32_err": float(np.abs(lg_card32 - lg32).max()),
           "f32_tol": LM_F32_ATOL,
           "tokens": tok.tolist(), "tokens_cpu": tok_cpu.tolist(),
           "tokens_equal": bool(torch.equal(tok, tok_cpu)),
           "steps_under_margin": int(under.sum()),
           "steps_compared": stop}
    emit(row)
    check(row["f32_err"] <= LM_F32_ATOL and row["logits_err"] <= tol
          and torch.equal(tok[:, :stop], tok_cpu[:, :stop]),
          f"lm_serve 2-layer tinyllama: the card is off the CPU: {row}")
    del model2, cpu2

    # (e) the driver, as a process of its own
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LM_ARCH,
         "--steps", "16"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    emit({"phase": "lm_serve", "step": "driver", "rc": proc.returncode,
          "seconds": time.perf_counter() - t0,
          "stdout": proc.stdout.strip().splitlines()[-2:],
          "stderr": proc.stderr.strip().splitlines()[-3:]})
    check(proc.returncode == 0, "launch.serve failed")
    launches = launch_counts()
    emit({"phase": "lm_serve", "step": "done", "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    check(not any(launches.values()),
          f"lm_serve: a hand-written kernel ran on the LM path: {launches}")
    return launches


# --------------------------------------------------------------- lm_train
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 12
TRAIN_LR = {"peak": 3e-3, "warmup": max(TRAIN_STEPS // 10, 1),
            "total": TRAIN_STEPS}          # launch/train.py's defaults
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 128    # the 2-layer step on the CPU
COMPRESS_RATIO, COMPRESS_MIN_SIZE = 0.01, 65536   # make_train_step's
# moments of two steps compared leaf by leaf, relative to max(the leaf's
# largest |value|, this share of the tree's largest): a key projection's
# bias has a true gradient of 0 (the softmax ignores a shift common to a
# query's logits), so its moments are rounding noise that any two
# summation orders make differently (tests/_torch_train.py)
MOMENT_NOISE_FLOOR = 1e-3
TRAIN_CKPT = ROOT / "build" / "chip_smoke_train_ckpt"


def params_gap(a, b) -> float:
    """Largest |difference| of two models' parameters."""
    with torch.no_grad():
        return max(float((x - y).abs().max()) for x, y in zip(
            a.parameters(), b.parameters()))


def moment_gap(a: dict, b: dict) -> float:
    """Largest gap of two moment dicts (parameter name -> tensor, on any
    device), each leaf relative to max(its largest |value| in ``b``,
    MOMENT_NOISE_FLOOR x the largest of all ``b``)."""
    top = max(float(t.abs().max()) for t in b.values())
    return max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max())
               / max(float(b[k].abs().max()), MOMENT_NOISE_FLOOR * top)
               for k in b)


def train_once(model, cfg, inputs: dict, dev, **kw):
    """One train step of a copy of ``model`` on ``dev`` (``launch/train.py``'s
    schedule): (the new state, metrics as floats)."""
    from repro_torch.models import Mode
    from repro_torch.train import make_train_step
    from repro_torch.train.loop import init_train_state

    lr = kw.pop("lr_kwargs", TRAIN_LR)
    state = init_train_state(copy.deepcopy(model).to(dev))
    step = make_train_step(cfg, Mode("train", "dense"), lr_kwargs=lr, **kw)
    state, m = step(state, lm_tensors(inputs, dev))
    return state, {k: float(v) for k, v in m.items()}


def train_card_vs_cpu(cfg, model, inputs: dict) -> dict:
    """(c) one train step of the same parameters and batch on the card and
    on the CPU: loss, ce and aux, and the moments (the clipped gradients
    and their squares), as configured and with both in float32 compute."""
    runs = {}
    for f32 in (False, True):
        with float32_compute() if f32 else contextlib.nullcontext():
            card, m_card = train_once(model, cfg, inputs, DEVICE)
            cpu, m_cpu = train_once(model, cfg, inputs, "cpu")
        runs[f32] = card, m_card, cpu, m_cpu
    (card, m_card, cpu, m_cpu), (card32, m_card32, cpu32, m_cpu32) = \
        runs[False], runs[True]
    row = {"arch": cfg.name, "loss": m_card["loss"], "loss_cpu": m_cpu["loss"],
           "grad_finite": bool(m_card["grad_finite"]
                               and m_card32["grad_finite"])}
    ok = row["grad_finite"]
    for key in ("loss", "ce", "aux"):
        err32 = abs(m_card32[key] - m_cpu32[key])
        own = abs(m_cpu[key] - m_cpu32[key])
        err = abs(m_card[key] - m_cpu[key])
        tol = max(LM_ATOL, LM_REF_SHARE * own)
        row[key] = {"f32_err": err32, "err": err, "cpu_bf16_err": own,
                    "tol": tol}
        ok = ok and err32 <= LM_F32_ATOL and err <= tol
    for field in ("mu", "nu"):
        def get(s):
            return getattr(s.opt, field)
        err32 = moment_gap(get(card32), get(cpu32))
        own = moment_gap(get(cpu), get(cpu32))
        err = moment_gap(get(card), get(cpu))
        tol = max(LM_ATOL, LM_REF_SHARE * own)
        row[field] = {"f32_err": err32, "err": err, "cpu_bf16_err": own,
                      "tol": tol}
        ok = ok and err32 <= LM_F32_ATOL and err <= tol
    row["ok"] = bool(ok)
    return row


def train_smoke_on_card_and_cpu(name: str) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.models import model_init

    cfg = get_arch(name + "-smoke")
    model, _ = model_init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    rng = np.random.default_rng(0)
    inputs = {"tokens": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)}
    if cfg.family == "audio":
        inputs["frames"] = (0.02 * rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model))).astype(np.float32)
    if cfg.family == "vlm":
        inputs["img_embeds"] = (0.02 * rng.standard_normal(
            (2, cfg.img_tokens, cfg.d_model))).astype(np.float32)
    row = train_card_vs_cpu(cfg, model, inputs)
    if cfg.n_experts:
        card = copy.deepcopy(model).to(DEVICE)
        differs = 0
        layers = list(zip(moe_routing(card, cfg, inputs, DEVICE),
                          moe_routing(model, cfg, inputs, "cpu")))
        for (mod_card, x_card), (mod_cpu, x_cpu) in layers:
            on_card = route(mod_card, x_card, cfg)
            differs += not all(np.array_equal(a, b) for a, b in zip(
                on_card, route(mod_cpu, x_cpu, cfg)))
        row.update(moe_layers=len(layers), routing_differs=differs)
        row["ok"] = row["ok"] and differs == 0
    return row


def start_train_process(args: list):
    """``python -m repro_torch.launch.train ARGS``, started."""
    return args, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def finish_train_process(started, timeout: int = 600):
    """Wait for a started driver (killed past ``timeout``): (its row: exit
    code, wall, the losses it printed, whether all are finite; its
    standard output's lines)."""
    args, t0, proc = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    lines = out.strip().splitlines()
    losses = [float(line.split("loss=")[1].split()[0]) for line in lines
              if line.startswith("[train] step")]
    return {"args": args, "rc": proc.returncode,
            "seconds": time.perf_counter() - t0, "stdout": lines[-4:],
            "stderr": err.strip().splitlines()[-3:],
            "losses": losses, "finite": bool(losses)
            and bool(np.isfinite(losses).all())}, lines


def train_process(args: list):
    return finish_train_process(start_train_process(args))


def run_lm_train(smi: str) -> dict:
    """(a) tinyllama-1.1b at full width and depth trained for TRAIN_STEPS
    steps on the card, (b) microbatches and top-k compression at full width
    cut to 2 layers, (c) one train step on the card against the CPU on the
    ten reduced architectures and on tinyllama cut to 2 layers, (d) the
    training driver as processes, a restart from its checkpoint included.
    Returns the five kernels' launches over the phase (all 0)."""
    from repro_torch.configs import arch_names, get_arch
    from repro_torch.data.pipeline import synthetic_token_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Mode, model_init
    from repro_torch.train import make_train_step
    from repro_torch.train.loop import init_train_state

    t_phase = time.perf_counter()
    reset_launch_counts()
    cfg = get_arch(LM_ARCH)
    stream = synthetic_token_stream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                    seed=0)
    batches = [{"tokens": next(stream)} for _ in range(TRAIN_STEPS)]
    on_card = [lm_tensors(b, DEVICE) for b in batches]

    # (a) full width and depth: step 1 twice from the same state, then on
    def fresh():
        model, _ = model_init(torch.Generator(DEVICE).manual_seed(0), cfg,
                              device=DEVICE)
        return init_train_state(model)

    step = make_train_step(cfg, Mode("train", "dense"), lr_kwargs=TRAIN_LR)
    state = fresh()
    n_params = sum(p.numel() for p in state.params.parameters())
    (state, m), first_s = timed_sync(lambda: step(state, on_card[0]))
    again, m_again = step(fresh(), on_card[0])
    rerun = {"loss_equal": float(m["loss"]) == float(m_again["loss"]),
             "loss_gap": abs(float(m["loss"]) - float(m_again["loss"])),
             "params_max_abs_gap": params_gap(state.params, again.params),
             "params_bit_equal": all(torch.equal(a, b) for a, b in zip(
                 state.params.parameters(), again.params.parameters())),
             "mu_gap": moment_gap(again.opt.mu, state.opt.mu),
             "nu_gap": moment_gap(again.opt.nu, state.opt.nu),
             "mu_bit_equal": all(torch.equal(again.opt.mu[k], v)
                                 for k, v in state.opt.mu.items())}
    del again
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics, times = [m], []
    for batch in on_card[1:]:
        (state, m), dt = timed_sync(lambda: step(state, batch))
        metrics.append(m)
        times.append(dt)
    peak = torch.cuda.max_memory_allocated()
    rows = [{k: float(v) for k, v in mm.items()} for mm in metrics]
    ce = [r["ce"] for r in rows]
    ms = float(np.mean(times)) * 1e3
    row = {"phase": "lm_train", "step": "full width", "arch": LM_ARCH,
           "card": smi, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "lr": TRAIN_LR,
           "first_step_ms": first_s * 1e3,
           "ms_per_step": ms, "ms_per_step_min": min(times) * 1e3,
           "ms_per_step_max": max(times) * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
           "peak_mem_gb": peak / 1e9,
           "loss": [r["loss"] for r in rows], "ce": ce,
           "first_ce": ce[0], "last5_mean_ce": float(np.mean(ce[-5:])),
           "all_finite": all(np.isfinite([r["loss"], r["ce"]]).all()
                             and r["grad_finite"] for r in rows),
           "step_1_twice": rerun}
    emit(row)
    check(row["all_finite"], f"lm_train: a loss or a gradient is not "
          f"finite: {row['loss']}")
    check(row["last5_mean_ce"] < row["first_ce"],
          f"lm_train: ce did not fall: {ce}")
    check(rerun["loss_gap"] <= LM_F32_ATOL
          and rerun["mu_gap"] <= LM_F32_ATOL
          and rerun["nu_gap"] <= LM_F32_ATOL,
          f"lm_train: two runs of step 1 disagree: {rerun}")
    del state
    torch.cuda.empty_cache()

    # (b) microbatches and compression at full width, 2 layers
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    model2, _ = model_init(torch.Generator(DEVICE).manual_seed(0), cfg2,
                           device=DEVICE)
    ref_lr = {"peak": 1e-3, "warmup": 1, "total": 10}   # test_train.py's
    micro = {}
    for f32 in (False, True):
        with float32_compute() if f32 else contextlib.nullcontext():
            one, m1 = train_once(model2, cfg2, batches[0], DEVICE,
                                 lr_kwargs=ref_lr)
            two, m2 = train_once(model2, cfg2, batches[0], DEVICE,
                                 lr_kwargs=ref_lr, microbatches=2)
        micro["f32" if f32 else "bf16"] = {
            "ce_gap": abs(m1["ce"] - m2["ce"]),
            "params_max_abs_gap": params_gap(one.params, two.params),
            "mu_gap": moment_gap(two.opt.mu, one.opt.mu),
            "nu_gap": moment_gap(two.opt.nu, one.opt.nu)}
        del one, two
    comp, mc = train_once(model2, cfg2, batches[0], DEVICE,
                          compress="topk", compress_ratio=COMPRESS_RATIO,
                          compress_min_size=COMPRESS_MIN_SIZE)
    leaves = []
    for name, mu in comp.opt.mu.items():
        n = mu.numel()
        kept = int((mu != 0).sum())
        if n < COMPRESS_MIN_SIZE:           # not compressed
            leaves.append({"leaf": name, "n": n, "compressed": False,
                           "kept": kept})
            continue
        k = max(1, int(n * COMPRESS_RATIO))
        smallest = mu[mu != 0].abs().min()
        ties = int((mu.abs() == smallest).sum())
        leaves.append({"leaf": name, "n": n, "compressed": True, "k": k,
                       "kept": kept, "kept_share": kept / n,
                       "ties_at_threshold": ties,
                       "ok": k <= kept <= k + ties - 1})
    row = {"phase": "lm_train", "step": "microbatches and compression",
           "arch": cfg2.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "microbatches_2_vs_1": micro, "compress_ratio": COMPRESS_RATIO,
           "compress_grad_finite": bool(mc["grad_finite"]),
           "compressed_leaves": sum(l["compressed"] for l in leaves),
           "leaves": leaves}
    emit(row)
    check(micro["f32"]["ce_gap"] <= LM_F32_ATOL
          and micro["bf16"]["ce_gap"] <= LM_F32_ATOL
          and micro["f32"]["params_max_abs_gap"] <= 1e-5
          and micro["bf16"]["params_max_abs_gap"] <= 1e-5
          and micro["f32"]["mu_gap"] <= LM_F32_ATOL
          and micro["f32"]["nu_gap"] <= LM_F32_ATOL,
          f"lm_train: microbatches=2 is off microbatches=1: {micro}")
    check(row["compress_grad_finite"] and row["compressed_leaves"] > 0
          and all(l.get("ok", True) for l in leaves),
          f"lm_train: compression kept other than the top share: {row}")
    del comp
    torch.cuda.empty_cache()

    # (c) the card against the CPU
    rows = [train_smoke_on_card_and_cpu(name) for name in arch_names()]
    emit({"phase": "lm_train", "step": "card vs cpu, -smoke", "archs": rows})
    check(all(r["ok"] for r in rows),
          f"lm_train: the card is off the CPU: "
          f"{[r for r in rows if not r['ok']]}")
    cpu2 = copy.deepcopy(model2).cpu()
    del model2
    rng = np.random.default_rng(1)
    inputs = {"tokens": rng.integers(0, cfg.vocab, (
        TRAIN_CPU_BATCH, TRAIN_CPU_SEQ)).astype(np.int32)}
    t0 = time.perf_counter()
    row = train_card_vs_cpu(cfg2, cpu2, inputs)
    row.update(phase="lm_train", step="card vs cpu, 2 layers full width",
               batch=TRAIN_CPU_BATCH, seq=TRAIN_CPU_SEQ,
               seconds=time.perf_counter() - t0)
    emit(row)
    check(row["ok"], f"lm_train 2-layer tinyllama: the card is off the "
          f"CPU: {row}")
    del cpu2
    torch.cuda.empty_cache()

    # (d) the driver, as processes: full width, and beside it a restart on
    # -smoke (each process takes ~10 s to import torch and reach the card)
    import shutil
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    ck = ["--arch", LM_ARCH, "--smoke", "--ckpt-dir", str(TRAIN_CKPT),
          "--ckpt-every", "5"]
    started = start_train_process(["--arch", LM_ARCH, "--steps", "5"])
    try:
        first, _ = train_process(ck + ["--steps", "10"])
        second, lines = train_process(ck + ["--steps", "15"])
    finally:
        full, _ = finish_train_process(started)
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    emit({"phase": "lm_train", "step": "driver, full width", **full})
    check(full["rc"] == 0 and full["finite"],
          f"launch.train at full width failed: {full}")
    restored = "[train] restored step 10" in lines
    emit({"phase": "lm_train", "step": "driver, restart", "first": first,
          "second": second, "restored_step_10": restored})
    check(first["rc"] == 0 and second["rc"] == 0 and restored
          and first["finite"] and second["finite"],
          f"launch.train restart failed: {first} {second}")
    launches = launch_counts()
    emit({"phase": "lm_train", "step": "done", "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    check(not any(launches.values()),
          f"lm_train: a hand-written kernel ran on the LM path: {launches}")
    return launches


# ------------------------------------------------------------- lm_elastic
ELASTIC_MOE_ARCH = "qwen3-moe-235b-a22b"   # d_model 4,096, 128 experts
ELASTIC_MOE_TOKENS = (4, 512)              # the global batch of the layer
ELASTIC_MOE_SEED = 23
# y, aux and the gradients: float32, TF32 off; max |error| over the
# compared quantity's own max |value| (floored at ELASTIC_MOE_FLOOR, so a
# quantity that is all zeros is held to an absolute bar)
ELASTIC_MOE_TOL = 2e-5
ELASTIC_MOE_FLOOR = 1e-30
ELASTIC_PROBE_EXPERTS = 2                  # whole gradients a model rank
ELASTIC_BATCH, ELASTIC_SEQ, ELASTIC_STEPS = 8, 512, 4
ELASTIC_LR = {"peak": 1e-3, "warmup": 2, "total": 20}
ELASTIC_LOSS_TOL = 1e-3   # tests/helpers/elastic_check.py's bar
ELASTIC_DIR = ROOT / "build" / "chip_smoke_elastic"


def moe_full_width():
    """qwen3-moe-235b-a22b's MoE layer: (d_model, d_ff, experts, top_k)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(ELASTIC_MOE_ARCH)
    return cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k


def moe_draws(model_axis=None):
    """The layer from a generator on the card seeded ELASTIC_MOE_SEED, in
    ``MoE(Init(...))``'s order of draws; with ``model_axis`` each expert
    weight is cut to that rank's experts right after its draw (so a rank
    never holds the whole layer)."""
    import math as _math

    from repro_torch.models.layers.common import Init
    from repro_torch.models.layers.moe import MoE
    d, f, e, _ = moe_full_width()
    moe = MoE(Init(None, device="meta"), d, f, e)
    gen = torch.Generator(DEVICE).manual_seed(ELASTIC_MOE_SEED)
    s_in, s_out = 1.0 / _math.sqrt(d), 1.0 / _math.sqrt(f)
    for name, shape, scale in (("router", (d, e), s_in),
                               ("gate", (e, d, f), s_in),
                               ("up", (e, d, f), s_in),
                               ("down", (e, f, d), s_out)):
        w = torch.randn(shape, generator=gen, device=DEVICE) * scale
        if model_axis is not None and name != "router":
            n = e // model_axis.size
            w = w.narrow(0, model_axis.index * n, n).clone()
        moe.add(name, torch.nn.Parameter(w), moe.specs[name])
    return moe


def moe_inputs():
    rng = np.random.default_rng(ELASTIC_MOE_SEED)
    shape = (*ELASTIC_MOE_TOKENS, moe_full_width()[0])
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def moe_step(moe, x, w, cf: float):
    """y, aux, top-k choices and the gradients of mean(y . w) + aux, timed
    (host clock around the synchronised forward and backward)."""
    from repro_torch.models.layers.moe import moe_apply, ordered_top_k
    x = x.clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = moe_apply(moe, x, top_k=moe_full_width()[3], capacity_factor=cf)
    ((out.y * w).sum() / (x.shape[0] * x.shape[1]) + out.aux_loss).backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    top_i = ordered_top_k(out.router_probs.detach(), moe_full_width()[3])[1]
    return out.y.detach(), out.aux_loss.item(), top_i, x.grad, ms


def moe_probe(moe, e_lo: int, n: int) -> dict:
    """Linear probes of the expert gradients (u^T g v for every expert, u
    and v fixed draws) and the whole gradients of the first and last of
    the experts [e_lo, e_lo + n): what the ranks' sums are held to."""
    d, f, _, _ = moe_full_width()
    gen = torch.Generator(DEVICE).manual_seed(1)
    u = torch.randn(d, generator=gen, device=DEVICE)
    v = torch.randn(f, generator=gen, device=DEVICE)
    out = {}
    for name in ("gate", "up", "down"):
        g = getattr(moe, name).grad
        g = g if g.shape[0] == n else g.narrow(0, e_lo, n)
        a, b = (u, v) if name != "down" else (v, u)
        out[f"{name}_probe"] = torch.einsum("edf,d,f->e", g, a, b)
        out[f"{name}_ends"] = torch.stack([g[0], g[-1]])
    out["router"] = moe.router.grad
    return out


def drops(moe, x, cf: float, e_lo: int, e_loc: int) -> int:
    """The choices for the experts [e_lo, e_lo + e_loc) that the capacity
    drops at ``cf`` (the rank's tokens count)."""
    from repro_torch.models.layers.moe import _route_and_dispatch, capacity
    d, _, e, k = moe_full_width()
    t = x.shape[0] * x.shape[1]
    cap = capacity(t, k, e, cf)
    with torch.no_grad():
        _, (inv, _, _, flat_e) = _route_and_dispatch(
            x.reshape(t, d), moe.router, k, e_lo, e_loc, cap)
    mine = (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
    return int((mine & (inv == e_loc * cap)).sum())


def elastic_rank(ref_path: str, x_np, w_np, ckdir: str) -> dict:
    """One of 4 ranks sharing the card: (a) the full-width MoE layer on a
    2 x 2 (data, model) mesh against the one-process layer's results in
    ``ref_path``; (b) tinyllama-1.1b (2 layers, full width) trained on the
    2 x 2 mesh, saved, restored onto a 1 x 2 mesh."""
    import dataclasses as _dc

    import torch.distributed as tdist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.data.pipeline import synthetic_token_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Mode, model_init
    from repro_torch.models.layers.common import tree_map
    from repro_torch.runtime.elastic import gather_state, reshard_state
    from repro_torch.sharding import dist
    from repro_torch.sharding.partitioning import set_mesh
    from repro_torch.train.loop import (
        init_train_state, make_train_step, train_state_specs,
    )

    entered = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_launch_counts()
    t_a = time.perf_counter()
    mesh = make_mesh((2, 2), ("data", "model"))
    mesh2 = make_mesh((1, 2), ("data", "model"))   # every rank builds it
    dax, max_ = mesh.axis("data"), mesh.axis("model")
    out = {"rank": dist.rank(), "coords": (dax.index, max_.index),
           "entered": entered}

    # (a) the MoE layer at full width, expert-parallel
    ref = torch.load(ref_path, map_location=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    moe = moe_draws(max_)
    e = moe_full_width()[2]
    e_loc = e // max_.size
    e_lo = max_.index * e_loc
    rows = slice(dax.index * 2, dax.index * 2 + 2)
    x = torch.from_numpy(x_np[rows]).to(DEVICE)
    w = torch.from_numpy(w_np[rows]).to(DEVICE)
    sent = mesh.traffic.bytes_sent
    with set_mesh(mesh):
        y, aux, top_i, gx, ms = moe_step(moe, x, w, 8.0)
        probe = moe_probe(moe, e_lo, e_loc)
        # the mesh step's reduction: the data ranks' mean
        summed = {k: dist.psum(v, dax) / dax.size for k, v in probe.items()}
        dropped_125 = dist.psum(torch.tensor(drops(moe, x, 1.25, e_lo,
                                                   e_loc)), dax)
    t = rows.stop - rows.start

    scales = {}

    def err(key: str, got, want) -> float:
        """max |got - want| over max |want| (floored); the scale is kept
        in ``scales``."""
        want = torch.as_tensor(want, device=DEVICE)
        scales[key] = float(want.abs().max())
        return float((torch.as_tensor(got, device=DEVICE) - want).abs().max()
                     / max(ELASTIC_MOE_FLOOR, scales[key]))
    errs = {"y": err("y", y, ref["y"][rows]),
            "aux": err("aux", aux, ref["aux"]),
            "x_grad": err("x_grad", gx / dax.size, ref["x_grad"][rows]),
            "router_grad": err("router_grad", summed["router"],
                               ref["router"])}
    for name in ("gate", "up", "down"):
        errs[f"{name}_probe"] = err(f"{name}_probe",
                                    summed[f"{name}_probe"],
                                    ref[f"{name}_probe"][e_lo:e_lo + e_loc])
        errs[f"{name}_ends"] = err(f"{name}_ends", summed[f"{name}_ends"],
                                   torch.stack(
            [ref[f"{name}_first"][max_.index],
             ref[f"{name}_last"][max_.index]]))
    out["moe"] = {
        "experts_held": e_loc, "tokens": t * ELASTIC_MOE_TOKENS[1],
        "ms_fwd_bwd": ms, "errors": errs, "scales": scales,
        "routing_equal": bool(torch.equal(
            top_i.cpu(), ref["top_i"].reshape(
                ELASTIC_MOE_TOKENS[0], ELASTIC_MOE_TOKENS[1], -1)[rows]
            .reshape(top_i.shape).cpu())),
        "dropped_at_1.25": int(dropped_125),
        "bytes_sent": mesh.traffic.bytes_sent - sent,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del moe, probe, summed, ref, gx, y
    torch.cuda.empty_cache()

    out["moe"]["rank_s"] = time.perf_counter() - t_a

    # (b) elastic training: tinyllama at full width, 2 layers
    t_b = time.perf_counter()
    cfg = _dc.replace(get_arch(LM_ARCH), n_layers=2)
    model, specs = model_init(torch.Generator(DEVICE).manual_seed(0), cfg,
                              device=DEVICE)
    state = init_train_state(model)
    state_specs = train_state_specs(specs)
    like = train_state_to_numpy(state)
    del model, state
    stream = synthetic_token_stream(cfg.vocab, ELASTIC_BATCH, ELASTIC_SEQ,
                                    seed=0)
    batches = [{"tokens": torch.as_tensor(next(stream), device=DEVICE)}
               for _ in range(2 * ELASTIC_STEPS)]
    torch.cuda.reset_peak_memory_stats()

    def train(st, step, part):
        losses, times = [], []
        for b in part:
            (st, m), dt = timed_sync(lambda: step(st, b))
            losses.append(float(m["loss"]))
            times.append(dt * 1e3)
        return st, losses, times

    sent = mesh.traffic.bytes_sent
    st = reshard_state(like, state_specs, mesh, device=DEVICE)
    step = make_train_step(cfg, Mode("train", "dense"),
                           lr_kwargs=ELASTIC_LR, mesh=mesh)
    _, setup_s = timed_sync(lambda: step.setup(st))
    st, first, t_first = train(st, step, batches[:ELASTIC_STEPS])
    (full, save_ms) = timed_sync(lambda: gather_state(st, state_specs, mesh))
    t0 = time.perf_counter()
    if dist.rank() == 0:
        CheckpointManager(ckdir, async_save=False).save(
            ELASTIC_STEPS, tree_map(lambda t: t.cpu().numpy(), full))
    save_ms = save_ms * 1e3 + (time.perf_counter() - t0) * 1e3
    del full
    tdist.barrier()
    st, cont, t_cont = train(st, step, batches[ELASTIC_STEPS:])
    out["train_2x2"] = {
        "losses": first + cont, "ms_per_step": t_first[1:] + t_cont,
        "setup_ms": setup_s * 1e3, "first_step_ms": t_first[0],
        "save_ms": save_ms,
        "bytes_sent": mesh.traffic.bytes_sent - sent,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del st, step
    torch.cuda.empty_cache()
    if mesh2.member:
        torch.cuda.reset_peak_memory_stats()
        sent = mesh2.traffic.bytes_sent
        t0 = time.perf_counter()
        step_no, restored = CheckpointManager(ckdir).restore_latest(like)
        st2 = reshard_state(restored, state_specs, mesh2, device=DEVICE)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        step2 = make_train_step(cfg, Mode("train", "dense"),
                                lr_kwargs=ELASTIC_LR, mesh=mesh2)
        st2, again, t_again = train(st2, step2, batches[ELASTIC_STEPS:])
        out["train_1x2"] = {
            "restored_step": step_no, "restore_ms": restore_ms,
            "losses": again, "ms_per_step": t_again,
            "bytes_sent": mesh2.traffic.bytes_sent - sent,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del st2, step2
    tdist.barrier()
    out["train_2x2"]["rank_s"] = time.perf_counter() - t_b
    out["launches"] = launch_counts()
    out["left"] = time.time()
    return out


def run_lm_elastic(smi: str) -> dict:
    """(c) the dry run (``python -m repro_torch.launch.dryrun --all --mesh
    both``) as a process beside (a) the full-width qwen3 MoE layer on a
    2 x 2 mesh of 4 ranks sharing the card, against the layer in one
    process (run first), and (b) elastic training of tinyllama-1.1b.
    Returns the five kernels' launches over the phase (all 0)."""
    import shutil

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sharding import dist

    t_phase = time.perf_counter()
    reset_launch_counts()
    ELASTIC_DIR.mkdir(parents=True, exist_ok=True)
    dry_out = ELASTIC_DIR / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t_dry = time.perf_counter()
    dry_log = open(ELASTIC_DIR / "dryrun.log", "w")
    # three of the host's eight cores for the dry run's pool (≈ 150 s of
    # counting in all), the rest for the ranks' host-staged collectives
    cores = sorted(os.sched_getaffinity(0))
    dry_cores = cores[:max(1, 3 * len(cores) // 8)]
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both", "--out", str(dry_out)], env=env,
        stdout=dry_log, stderr=subprocess.STDOUT,
        preexec_fn=lambda: os.sched_setaffinity(0, dry_cores))
    try:
        # (a), one process first: the whole layer and its gradients
        x_np, w_np = moe_inputs()
        moe = moe_draws()
        n_params = sum(p.numel() for p in moe.parameters())
        x, w = (torch.from_numpy(a).to(DEVICE) for a in (x_np, w_np))
        torch.cuda.reset_peak_memory_stats()
        moe_step(moe, x, w, 8.0)                   # warm-up
        for p in moe.parameters():
            p.grad = None
        y, aux, top_i, gx, ms = moe_step(moe, x, w, 8.0)
        e = moe_full_width()[2]
        ref = {"y": y, "aux": torch.tensor(aux), "top_i": top_i,
               "x_grad": gx}
        for half in range(2):
            probe = moe_probe(moe, half * e // 2, e // 2)
            for name in ("gate", "up", "down"):
                ref.setdefault(f"{name}_probe", []).append(
                    probe[f"{name}_probe"])
                ref.setdefault(f"{name}_first", []).append(
                    probe[f"{name}_ends"][0])
                ref.setdefault(f"{name}_last", []).append(
                    probe[f"{name}_ends"][1])
            ref["router"] = probe["router"]
        for name in ("gate", "up", "down"):
            ref[f"{name}_probe"] = torch.cat(ref[f"{name}_probe"])
            ref[f"{name}_first"] = torch.stack(ref[f"{name}_first"])
            ref[f"{name}_last"] = torch.stack(ref[f"{name}_last"])
        dense_drops = drops(moe, x, 1.25, 0, e)
        one = {"ms_fwd_bwd": ms, "params": n_params,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "dropped_at_1.25": dense_drops}
        ref_path = ELASTIC_DIR / "moe_ref.pt"
        torch.save({k: v.cpu() for k, v in ref.items()}, ref_path)
        del moe, ref, probe, y, gx, x, w
        torch.cuda.empty_cache()

        ckdir = ELASTIC_DIR / "ckpt"
        shutil.rmtree(ckdir, ignore_errors=True)
        one["phase_s_before_group"] = time.perf_counter() - t_phase
        t0, spawned = time.perf_counter(), time.time()
        ranks = dist.spawn(elastic_rank, 4, device=DEVICE,
                           args=(str(ref_path), x_np, w_np, str(ckdir)))
        group_s = time.perf_counter() - t0
        # the group's start (spawn to the last rank's entry) and end (the
        # first rank's return to the group's end), host clocks
        group_start_s = max(r["entered"] for r in ranks) - spawned
        group_end_s = spawned + group_s - min(r["left"] for r in ranks)
    except BaseException:
        dry.kill()
        dry.wait()
        dry_log.close()
        raise
    finally:
        shutil.rmtree(ELASTIC_DIR / "ckpt", ignore_errors=True)
    d, f, e, k = moe_full_width()
    moe_rows = [r["moe"] | {"coords": r["coords"]} for r in ranks]
    worst = {key: max(r["errors"][key] for r in moe_rows)
             for key in moe_rows[0]["errors"]}
    least_scale = {key: min(r["scales"][key] for r in moe_rows)
                   for key in moe_rows[0]["scales"]}
    emit({"phase": "lm_elastic", "step": "moe layer, full width",
          "arch": ELASTIC_MOE_ARCH, "card": smi, "d_model": d, "d_ff": f,
          "experts": e, "top_k": k, "tokens": ELASTIC_MOE_TOKENS,
          "mesh": "2x2 (data, model), expert-parallel",
          "one_process": one, "ranks": moe_rows, "max_errors": worst,
          "least_scales": least_scale, "tolerance": ELASTIC_MOE_TOL,
          "group_s": group_s, "group_start_s": group_start_s, "group_end_s": group_end_s})
    check(all(r["routing_equal"] for r in moe_rows),
          f"lm_elastic: the sharded routing differs from one process")
    check(all(v <= ELASTIC_MOE_TOL for v in worst.values()),
          f"lm_elastic: the sharded MoE is off the one-process layer: "
          f"{worst}")
    two = [r["train_2x2"] for r in ranks]
    one_two = [r["train_1x2"] for r in ranks if "train_1x2" in r]
    gap = max(abs(a - b) for r in one_two for a, b in zip(
        r["losses"], two[0]["losses"][ELASTIC_STEPS:]))
    emit({"phase": "lm_elastic", "step": "elastic training",
          "arch": LM_ARCH, "layers": 2, "card": smi,
          "batch": ELASTIC_BATCH, "seq": ELASTIC_SEQ,
          "mesh_2x2": two, "mesh_1x2_restored": one_two,
          "restart_loss_gap": gap, "tolerance": ELASTIC_LOSS_TOL})
    check(all(r["losses"] == two[0]["losses"] for r in two),
          "lm_elastic: the 2 x 2 ranks disagree on the losses")
    check(len(one_two) == 2 and all(r["restored_step"] == ELASTIC_STEPS
                                    for r in one_two)
          and gap < ELASTIC_LOSS_TOL and np.isfinite(two[0]["losses"]).all(),
          f"lm_elastic: the restart is off the uninterrupted run: {gap}")

    # (c) the dry run
    try:
        dry.wait(timeout=600)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
        dry_log.close()
    waited_s = time.perf_counter() - t_dry
    text = (ELASTIC_DIR / "dryrun.log").read_text()
    summary = [line for line in text.splitlines()
               if line.startswith("[dryrun]")]
    res = json.loads(dry_out.read_text()) if dry_out.exists() else {}
    cells = len(res.get("results", []))
    emit({"phase": "lm_elastic", "step": "dry run", "rc": dry.returncode,
          "cells": cells, "failures": len(res.get("failures", [])),
          "cores": len(dry_cores),
          "seconds": float(summary[-1].rsplit(",", 1)[1].split()[0])
          if summary else None,
          "cell_s": {f"{r['arch']} {r['shape']} {r['mesh']}": r["count_s"]
                     for r in res.get("results", [])},
          "phase_s_at_wait": waited_s, "summary": summary})
    check(dry.returncode == 0 and cells == 64,
          f"lm_elastic: the dry run failed: {text[-2000:]}")
    launches = launch_counts()
    for r in ranks:
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    emit({"phase": "lm_elastic", "step": "done", "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    check(not any(launches.values()),
          f"lm_elastic: a hand-written kernel ran on the path: {launches}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a short fused solve with torch.profiler")
    ap.add_argument("--only", choices=["lm_serve", "lm_train",
                                       "lm_elastic"],
                    help="run the env phase and this one LM phase (they "
                    "need no kernel built), print its launches, and stop "
                    "without the last line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.data import (
        gaussian_blobs, image_to_points, mandrill_like_image,
    )
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    if args.only:
        run = {"lm_serve": run_lm_serve, "lm_train": run_lm_train,
               "lm_elastic": run_lm_elastic}
        launches = run[args.only](smi)
        if args.profile and args.only == "lm_train":
            profile_train()
        print(smi, flush=True)
        emit({"only": args.only, "launches": launches})
        return 0

    t_start = time.perf_counter()

    def clock(after: str) -> None:
        """Seconds since the script's start, after each phase."""
        emit({"phase": "clock", "after": after,
              "t_s": time.perf_counter() - t_start})

    t0 = time.perf_counter()
    _build.lib()
    info = _build.build_info()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "cached": info.cached, "ptxas": info.ptxas})

    pixels = image_to_points(mandrill_like_image(103, 103))
    blobs, truth = gaussian_blobs(n=N_BLOBS, k=16, seed=0, spread=0.5)
    x = torch.from_numpy(pixels).to(DEVICE)
    summary = run_kernels(x)
    summary["median_select"] = run_median_select(x, blobs)
    del x
    clock("kernels")
    summary["topk_build"] = run_topk_kernel(
        blobs, image_to_points(mandrill_like_image(512, 512)))
    clock("topk")
    launches = run_solve(pixels)                    # dense_fused path
    clock("solve")
    topk_launches, topk_res = run_solve_topk(blobs)
    launches["topk_build"] = topk_launches["topk_build"]
    clock("solve_topk")
    summary["flash_attention"] = run_attention()
    launches["flash_attention"] = summary["flash_attention"].pop("launches")
    emit({"phase": "launches", "launches": launches})
    clock("attention")
    run_solve_twostage(blobs,
                       image_to_points(mandrill_like_image(512, 512)))
    clock("solve_twostage")
    run_solve_streaming(blobs)
    clock("solve_streaming")
    coarsen_res = run_solve_coarsen()
    clock("solve_coarsen")
    paths = {"dense_topk (default solve)": launches["topk_build"]}
    graph_paths, graph_one = run_solve_graph(blobs, topk_res)
    paths.update(graph_paths)
    clock("solve_graph")
    from repro_torch.baselines import kmeans
    # the port's default initial centers for seed 0 (no step taken)
    init_centers = kmeans(torch.from_numpy(blobs).to(DEVICE), K_MEANS,
                          iterations=0, seed=0).centers.cpu().numpy()
    similarity_paths = run_solve_distributed(pixels, blobs, graph_one,
                                             init_centers)
    clock("solve_distributed")
    del topk_res
    paths.update(run_baselines(blobs, truth, init_centers))
    clock("baselines")
    paths.update(run_solve_checkpoint(blobs, coarsen_res))
    clock("solve_checkpoint")
    paths.update(run_serve(smi))
    clock("serve")
    lm_launches = run_lm_serve(smi)
    clock("lm_serve")
    train_launches = run_lm_train(smi)
    clock("lm_train")
    elastic_launches = run_lm_elastic(smi)
    clock("lm_elastic")
    emit({"phase": "launches", "topk_build_by_path": paths})
    check(all(paths.values()), f"a path launched no topk_build: {paths}")
    if args.profile:
        profile_all(pixels, blobs)
        profile_train()

    kernels = []
    for name, fn_line in (("similarity", "similarity.py:35"),
                          ("responsibility", "responsibility.py:71"),
                          ("availability", "availability.py:68"),
                          ("topk_build", "topk_build_fused.py:94"),
                          ("flash_attention", "flash_attention.py:77"),
                          ("median_select", None)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{fn_line}" if fn_line else
            "none: the reference takes the median with jnp.sort",
            "launches": launches[name], **summary[name],
            "lm_serve_launches": lm_launches[name],
            "lm_train_launches": train_launches[name],
            "lm_elastic_launches": elastic_launches[name]})
        if name == "topk_build":
            kernels[-1]["launches_by_path"] = paths
        if name == "similarity":
            kernels[-1]["launches_by_path"] = similarity_paths
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
