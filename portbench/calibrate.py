"""Readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 3 4 5

For each seed of ``--seeds`` the cell's program makes the run's pool and
runs each input once as the window does, and its answers are compared
with the plain reference as its judge compares them: the run's numbers
are the worst over its pool. For each seed of ``--control-seeds`` the
control takes the program's place: the reference computed in the
nearest precision below the one the configuration states (the program
module's ``readings`` says which). The lower reading of a number is the
largest the program gives, its upper reading the smallest the control
gives; each cell's limit lies between (``portbench/cells/<cell>.json``).
One JSON line a seed, then the readings; the benchmark's runs do not run
this.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import device, programs, spec  # noqa: E402


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
    prog = programs.of(cell)
    lower, upper = {}, {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        line = prog.readings(cell, seed, seed in args.seeds,
                             seed in args.control_seeds)
        for k, v in line.get("program", {}).items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in line.get("control", {}).items():
            upper[k] = min(upper.get(k, v), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": cell.name, "lower": lower,
                      "upper": upper, "limits": cell.limits,
                      "card": device.smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
