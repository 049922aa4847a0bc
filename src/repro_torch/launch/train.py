"""Training driver (port of ``repro/launch/train.py``): train a model of
the registry on synthetic tokens, on the card unless ``--device cpu``.

    python -m repro_torch.launch.train --arch tinyllama-1.1b [--smoke] \\
        [--steps 50] [--batch 8] [--seq 128] [--microbatches 1] \\
        [--compress topk] [--ckpt-dir D] [--ckpt-every 25] [--lr 3e-3] \\
        [--device cpu]

Wires together config -> model -> train step -> checkpointing -> restart
policy. The model is initialised at random from a generator seeded with 0
(the reference's ``PRNGKey(0)`` draws other values). With ``--ckpt-dir``
the state is saved every ``--ckpt-every`` steps and at the end in the
reference's format, and a run resumes from the newest checkpoint there.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.data.pipeline import Prefetcher, synthetic_token_stream
from repro_torch.models import model_init, pick_mode
from repro_torch.runtime.fault import FaultPolicy, run_with_restarts
from repro_torch.solver.engine import resolve_device
from repro_torch.train.loop import init_train_state, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced (CPU-sized) config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", choices=["topk"], default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch + ("-smoke" if args.smoke else ""))
    device = resolve_device(args.device)
    mode = pick_mode(cfg, "train", args.seq)
    step_fn = make_train_step(
        cfg, mode, microbatches=args.microbatches, compress=args.compress,
        lr_kwargs={"peak": args.lr, "warmup": max(args.steps // 10, 1),
                   "total": args.steps})
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    def restore():
        params, _ = model_init(torch.Generator(device).manual_seed(0), cfg,
                               device=device)
        state = init_train_state(params)
        if mgr is not None and mgr.steps():
            step, tree = mgr.restore_latest(train_state_to_numpy(state))
            print(f"[train] restored step {step}", flush=True)
            return step, train_state_from_numpy(tree, cfg, device)
        return 0, state

    def run(start_state):
        start, state = start_state
        stream = Prefetcher(synthetic_token_stream(
            cfg.vocab, args.batch, args.seq, seed=start))
        t0 = time.time()
        for i in range(start, args.steps):
            batch = {"tokens": torch.as_tensor(next(stream), device=device)}
            if cfg.family == "vlm":
                batch["img_embeds"] = torch.zeros(
                    (args.batch, cfg.img_tokens, cfg.d_model), device=device)
            if cfg.family == "audio":
                batch["frames"] = torch.zeros(
                    (args.batch, cfg.enc_seq, cfg.d_model), device=device)
            state, metrics = step_fn(state, batch)
            if mgr is not None and (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, train_state_to_numpy(state))
            if i % 10 == 0 or i == args.steps - 1:
                print(f"[train] step {i} loss={float(metrics['loss']):.4f} "
                      f"ce={float(metrics['ce']):.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"({time.time() - t0:.1f}s)", flush=True)
        stream.close()
        if mgr is not None:
            mgr.save(args.steps, train_state_to_numpy(state))
            mgr.wait()
        return state

    run_with_restarts(lambda s=None: run(restore()), lambda: None,
                      FaultPolicy(checkpoint_every=args.ckpt_every))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
