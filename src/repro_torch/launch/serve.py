"""LM serving driver (port of ``repro/launch/serve.py``): prefill a batch of
random prompts and step-decode, on the card unless ``--device cpu``.

    python -m repro_torch.launch.serve --arch tinyllama-1.1b [--smoke] \\
        [--steps 16] [--device cpu]

The model is initialised at random from its config (no weights are
loaded), from a generator seeded with 0, as the reference's ``PRNGKey(0)``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.models import model_init
from repro_torch.serve.engine import ServeEngine
from repro_torch.solver.engine import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced (CPU-sized) config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch + ("-smoke" if args.smoke else ""))
    device = resolve_device(args.device)
    gen = torch.Generator(device).manual_seed(0)
    params, _ = model_init(gen, cfg, device=device)
    prefix = cfg.img_tokens if cfg.family == "vlm" else 0
    engine = ServeEngine(cfg, params, max_len=args.prompt_len + args.steps
                         + 8 + prefix)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=device, dtype=torch.int32)
    extras = {}
    if cfg.family == "audio":
        extras["frames"] = torch.zeros(
            (args.batch, cfg.enc_seq, cfg.d_model), device=device)
    if cfg.family == "vlm":
        extras["img_embeds"] = torch.zeros(
            (args.batch, cfg.img_tokens, cfg.d_model), device=device)
    t0 = time.perf_counter()
    out = engine.generate(prompts, steps=args.steps,
                          temperature=args.temperature, generator=gen,
                          extras=extras)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[serve] {cfg.name} on {where}: generated {tuple(out.shape)} in "
          f"{dt:.3f}s ({args.batch * args.steps / dt:.1f} tok/s)")
    print(out[0][:16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
