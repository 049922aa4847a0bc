"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's pool of inputs from the seed, moves them to the
card as float32, and warms up with one ``solve()`` of the cell's own
shape (the kernels load, or on a checkout's first run build, into
``build/repro_torch_kernels/``). The window then calls
``repro_torch.solver.solve`` on the pool's inputs in turn, back to back,
for ``--seconds``; each call's time is the host clock around it, closed
by ``torch.cuda.synchronize()``. With ``--trace 1`` the same window runs
under ``torch.profiler`` with spans around the program's layers, and the
result carries the per-layer metrics instead of the end-to-end ones.
After the window the plain reference judges every call (``check.py``).

The last line of standard output is the result as one JSON object; the
compared numbers and their limits are also the last lines of standard
error. Without a CUDA card for the cell the run prints no result and
exits with 2; with JAX or the JAX package loaded, with 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, device, loadgen, spec, tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(2 ** 30)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  .intersection(FORBIDDEN))


def shapes(cell, x) -> dict:
    return {"n": int(x.shape[0]), "d": int(x.shape[1]),
            "k": cell.solve.get("k"), "levels": cell.solve["levels"],
            "layout": cell.config["reference"]["layout"]}


def run_cell(cell, seed: int, seconds: float, trace: bool, dev: str,
             t_start: float) -> dict:
    """Set-up, window and judgement of one run; -> the result's fields
    (without the device block's name)."""
    from repro_torch.solver import solve

    on_card = dev == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    marks = [time.perf_counter()]
    pool_np = loadgen.make_pool(cell.data, cell.mix["pool"], seed)
    marks.append(time.perf_counter())
    pool = [torch.from_numpy(x).to(dev) for x in pool_np]
    sync()
    marks.append(time.perf_counter())
    overrides = {**cell.solve, "device": dev}

    def call(x):
        return solve(x, **overrides)

    call(pool[0])                       # warm-up: the cell's own shape
    sync()
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t_start
    print("portbench: set-up {:.3f} s: imports {:.3f}, inputs {:.3f}, to the "
          "device {:.3f}, warm-up solve {:.3f}".format(
              setup_s, marks[0] - t_start, *(b - a for a, b in
                                             zip(marks, marks[1:]))),
          file=sys.stderr)

    timed, prof, spans = call, None, None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        if trace:
            spans = stack.enter_context(tracing.Spans(cell.config["spans"]))
            prof = stack.enter_context(tracing.profile(dev))

            def timed(x):
                with tracing.record_function(tracing.PREFIX + "solve"):
                    return call(x)
        with tracing.record_function(tracing.PREFIX + "window"):
            calls, window_s = loadgen.closed_loop(timed, pool, seconds, sync)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    ok = [c for c in calls if c.error is None]
    out = {"attempted": len(calls), "peak": peak}
    if trace:
        reading = tracing.read(
            prof, calls=len(calls),
            sweeps=sum(c.result.n_sweeps for c in ok),
            shapes=shapes(cell, pool_np[0]),
            missing=spans.missing)
        out["metrics"] = per_layer(cell, reading)
        out["busy_s"] = reading.busy_ns / 1e9
        out["window_s"] = reading.window_ns / 1e9
        out["breakdown"] = {"device_ops": reading.top_ops,
                            "idle_gaps": reading.idle_gaps}
    else:
        times = [c.seconds for c in ok]
        values = {
            "solve_s": window_s / len(ok) if ok else None,
            "solve_p90_s": float(np.percentile(times, 90)) if ok else None,
            "peak_mem_gib": peak / GIB,
            "setup_s": setup_s,
        }
        # the dense cells' own names for the same two readings, held to
        # a bound of their own (their runs spread far less)
        values["dense_solve_s"] = values["solve_s"]
        values["dense_solve_p90_s"] = values["solve_p90_s"]
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end
                          if values.get(m["name"]) is not None}
    del pool, prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out["judged"] = check.judge(cell, pool_np, calls, dev)
    return out


def per_layer(cell, reading) -> dict:
    out = {}
    for m in cell.per_layer:
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        value = reader.read(reading)
        if value is None:
            print(f"portbench: {m['name']}: nothing to read in this run",
                  file=sys.stderr)
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(out: dict, dev_block: dict, trace: bool) -> dict:
    """The result's JSON object: the contract's keys, ``breakdown`` when
    traced, and the compared numbers with their limits last."""
    judged = out["judged"]
    if trace:
        dev_block = {**dev_block, "busy_s": out["busy_s"],
                     "window_s": out["window_s"]}
    result = {"correct": judged["correct"], "attempted": out["attempted"],
              "failed": judged["failed"], "metrics": out["metrics"],
              "device": dev_block}
    if trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = judged["numbers"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    why = device.available(cell.chips)
    if why is not None:
        print(f"portbench: no card for {cell.name}: {why}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)

    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {found}, which the port may not load",
              file=sys.stderr)
        return 3
    judged = out["judged"]
    print(json.dumps({"card": device.smi(), "judged": {k: judged[k] for k in (
        "compared", "failed", "why")}}), flush=True)
    dev_block = device.block(cell.chips, out["peak"])
    result = result_line(out, dev_block, bool(args.trace))
    for name, v in judged["numbers"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
