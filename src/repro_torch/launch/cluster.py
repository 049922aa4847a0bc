"""MR-HAP clustering driver (port of ``repro/launch/cluster.py``) — the
paper's application, end to end, on W ranks:

    PYTHONPATH=src python -m repro_torch.launch.cluster --workers 4 \
        --dataset aggregation --levels 3 --iterations 30 --damping 0.5 \
        --comm-mode stats                     # 4 ranks on this host's cards

    PYTHONPATH=src python -m repro_torch.launch.cluster --workers 4 \
        --device cpu                          # 4 ranks on the CPU (gloo)

    PYTHONPATH=src torchrun --nproc-per-node 4 \
        -m repro_torch.launch.cluster --parallel-mode 2d

Builds the similarity tensor (paper §2: negative squared Euclidean,
preferences on the diagonal), runs distributed MR-HAP over the ranks — a
group that ``torchrun`` started, else ``--workers`` ranks spawned here
(one card each while there are cards enough, gloo with host copies when
they share one) — reports per-level cluster counts and purity, and with
``--ckpt`` saves the closed message state (the ranks' blocks gathered, in
the padded N) in the reference's checkpoint format. Without a card and
without ``--device cpu`` the driver exits with an error.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save_tree
from repro_torch.core import (
    link_hierarchy, make_preferences, pad_similarity, pairwise_similarity,
    purity, run_mrhap, run_mrhap_2d, set_preferences, stack_levels,
)
from repro_torch.core.mrhap import gather_blocks
from repro_torch.data import (
    aggregation_like, buttons_image, gaussian_blobs, image_to_points,
    mandrill_like_image, two_moons,
)
from repro_torch.launch.mesh import make_mesh, make_worker_mesh
from repro_torch.sharding import dist

DATASETS = {
    "aggregation": lambda seed: aggregation_like(seed),
    "blobs": lambda seed: gaussian_blobs(seed=seed),
    "moons": lambda seed: two_moons(seed=seed),
    "mandrill": lambda seed: (
        image_to_points(mandrill_like_image(seed=seed), subsample=12), None),
    "buttons": lambda seed: (
        image_to_points(buttons_image(seed=seed), subsample=12), None),
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=sorted(DATASETS),
                    default="aggregation")
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--damping", type=float, default=0.5)
    ap.add_argument("--comm-mode", choices=["stats", "transpose"],
                    default="stats")
    ap.add_argument("--parallel-mode", choices=["1d", "2d"], default="1d",
                    help="2d: tile decomposition over a rows x cols mesh "
                         "(lifts the paper's M <= L*N worker ceiling)")
    ap.add_argument("--preference", choices=["median", "random", "range_mid"],
                    default="random")
    ap.add_argument("--pref-low", type=float, default=-1e6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--workers", type=int, default=1,
                    help="ranks to spawn on this host (ignored under "
                         "torchrun, whose group sets them)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (ranks round-robin over the cards) or "
                         "'cpu'")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> list[str]:
    """One rank's run; returns the report lines (the same on every rank)."""
    device = torch.device(args.device)    # the rank's card is current
    x, labels = DATASETS[args.dataset](args.seed)
    n = len(x)
    lines = [f"[cluster] {args.dataset}: {n} points, L={args.levels}"]
    s = pairwise_similarity(torch.from_numpy(x).to(device))
    pref = make_preferences(
        s, args.preference, generator=torch.Generator().manual_seed(args.seed),
        low=args.pref_low)
    s3 = stack_levels(set_preferences(s, pref), args.levels)

    world = dist.world_size()
    if args.parallel_mode == "2d":
        rows = max(int(world ** 0.5), 1)
        cols = max(world // rows, 1)
        mesh = make_mesh((rows, cols), ("rows", "cols"))
        s3p, n_real = pad_similarity(s3, rows * cols)
        t0 = time.perf_counter()
        res = run_mrhap_2d(s3p, mesh, iterations=args.iterations,
                           damping=args.damping)
    else:
        mesh = make_worker_mesh()
        s3p, n_real = pad_similarity(s3, mesh.size)
        t0 = time.perf_counter()
        res = run_mrhap(s3p, mesh, iterations=args.iterations,
                        damping=args.damping, comm_mode=args.comm_mode)
    exemplars = res.exemplars.cpu().numpy()[:, :n_real]
    dt = time.perf_counter() - t0
    hier = link_hierarchy(exemplars)
    for l in range(args.levels):
        line = f"[cluster] L{l}: k={hier.n_clusters[l]}"
        if labels is not None:
            line += f" purity={purity(hier.labels[l], labels):.3f}"
        lines.append(line)
    lines.append(f"[cluster] workers={mesh.size} transport={mesh.transport} "
                 f"mode={args.comm_mode}/{args.parallel_mode} "
                 f"time={dt:.2f}s")
    if args.ckpt:
        r, a = gather_blocks(res.r, mesh), gather_blocks(res.a, mesh)
        if dist.rank() == 0:
            save_tree(args.ckpt, {"r": r, "a": a,
                                  "exemplars": res.exemplars})
        lines.append(f"[cluster] state checkpointed to {args.ckpt}")
    return lines


def main(argv=None) -> int:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("cluster: CUDA is not available; pass --device cpu "
                         "to run the ranks on the CPU")
    if dist.maybe_init_distributed(args.device) or args.workers == 1:
        lines = run(args)
        if dist.rank() != 0:
            return 0
    else:
        lines = dist.spawn(run, args.workers, device=args.device,
                           args=(args,))[0]
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
