"""Readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 3 4 5

For each seed of ``--seeds`` it makes the run's pool, solves each input
once as the window does, and compares each answer with the plain
reference as ``check.py`` does: the run's numbers are the worst over its
pool. For each seed of ``--control-seeds`` it puts the control in the
program's place: the reference computed at TF32 precision
(``reference.precision.tf32``), the nearest precision below the
configuration's float32. The lower reading of a number is the largest the
program gives, its upper reading the smallest the control gives; each
cell's limit lies between (``portbench/cells/<cell>.json``). One JSON line
a seed, then the readings; the benchmark's runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from portbench import check, device, loadgen, reference, spec  # noqa: E402
from portbench.reference import precision  # noqa: E402


def worst(a: dict, b: dict) -> dict:
    return {k: max(a.get(k, 0.0), b[k]) for k in b}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    why = device.available(cell.chips)
    if why is not None:
        print(f"calibrate: {why}", file=sys.stderr)
        return 2
    from repro_torch.solver import solve

    cfg = cell.reference_config()
    overrides = {**cell.solve, "device": "cuda"}
    lower, upper = {}, {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        pool = loadgen.make_pool(cell.data, cell.mix["pool"], seed)
        prog, ctl, t_ref, t_ctl = {}, {}, 0.0, 0.0
        for x in pool:
            t0 = time.perf_counter()
            ref = reference.decisions(cfg, x, "cuda")
            t_ref += time.perf_counter() - t0
            if seed in args.seeds:
                res = solve(torch.from_numpy(x).cuda(), **overrides)
                bad = check.failure(
                    loadgen.Call(0, 0.0, res, None), cell.config["route"],
                    cfg["sweeps"])
                if bad:
                    print(f"calibrate: seed {seed}: {bad}", file=sys.stderr)
                    return 1
                prog = worst(prog, check.gaps(res.exemplars, ref))
                del res
            if seed in args.control_seeds:
                t0 = time.perf_counter()
                e = reference.decisions(cfg, x, "cuda", precision.tf32)
                t_ctl += time.perf_counter() - t0
                ctl = worst(ctl, check.gaps(e, ref))
            torch.cuda.empty_cache()
        line = {"seed": seed, "reference_s": t_ref, "control_s": t_ctl}
        if prog:
            line["program"] = prog
            lower = worst(lower, prog)
        if ctl:
            line["control"] = ctl
            upper = {k: min(upper.get(k, v), v) for k, v in ctl.items()}
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": cell.name, "lower": lower,
                      "upper": upper, "limits": cell.limits,
                      "card": device.smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
