"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration names its program (``portbench/programs/``,
imported for this cell alone). Set-up is the program's: its pool of
inputs from the seed, what it runs on, and a warm-up of the cell's own
shapes. The window then makes the program's timed call on the pool's
inputs in turn, back to back, for ``--seconds``; each call's time is the
host clock around it, closed by ``torch.cuda.synchronize()``. With
``--trace 1`` the same window runs under ``torch.profiler`` with spans
around the program's layers, and the result carries the per-layer
metrics instead of the end-to-end ones. After the window, once the peak
memory is read, the program's plain reference judges the calls.

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

import torch  # noqa: E402

from portbench import device, loadgen, programs, spec, tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(2 ** 30)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  .intersection(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, dev: str,
             t_start: float) -> dict:
    """Set-up, window and judgement of one run; -> the result's fields
    (without the device block's name)."""
    prog = programs.of(cell)
    on_card = dev == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    run = prog.Run(cell, seed, dev, sync)
    setup_s = time.perf_counter() - t_start
    print("portbench: set-up {:.3f} s: imports {:.3f}, {}".format(
        setup_s, t0 - t_start,
        ", ".join(f"{label} {s:.3f}" for label, s in run.steps)),
        file=sys.stderr)

    timed, prof, spans = run.call, None, None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        if trace:
            spans = stack.enter_context(run.spans())
            prof = stack.enter_context(tracing.profile(dev, prog.HOST_OPS))

            def timed(x):
                with tracing.record_function(tracing.PREFIX + prog.CALL_SPAN):
                    return run.call(x)
        with tracing.record_function(tracing.PREFIX + "window"):
            calls, window_s = loadgen.closed_loop(timed, run.inputs,
                                                  seconds, sync)
        t0 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    print("portbench: window {:.3f} s, calls' seconds {}{}".format(
        window_s, [round(c.seconds, 4) for c in calls],
        f"; profile closed in {time.perf_counter() - t0:.1f} s" if trace
        else ""), file=sys.stderr)

    out = {"attempted": len(calls), "peak": peak}
    if trace:
        t0 = time.perf_counter()
        sweeps, shapes = run.counts(calls)
        reading = tracing.read(prof, calls=len(calls), sweeps=sweeps,
                               shapes=shapes, missing=spans.missing)
        out["metrics"] = per_layer(cell, reading)
        print(f"portbench: trace read in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
        out["busy_s"] = reading.busy_ns / 1e9
        out["window_s"] = reading.window_ns / 1e9
        out["breakdown"] = {"device_ops": reading.top_ops,
                            "idle_gaps": reading.idle_gaps}
    else:
        values = {**run.values(calls, window_s), "peak_mem_gib": peak / GIB,
                  "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end
                          if values.get(m["name"]) is not None}
    del timed, prof
    run.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["judged"] = prog.judge(cell, run, calls, dev)
    print(f"portbench: judged in {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
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
