"""CPU tests of the benchmark's harness: BENCHMARK.json and the files it
names, the generators, the roofline counts, the result line, and a run
without a card."""
from __future__ import annotations

import importlib
import io
import json
import re
import time
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import _tiny, loadgen, programs, roofline, run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in CELLS
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 and len(w["why"]) <= 200
               for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    cell = spec.find_cell(BENCH, name)
    conf = {c["name"]: c for c in BENCH["configs"]}[cell.config["name"]]
    assert cell.config["reduced"] == conf["reduced"]
    assert set(cell.limits) == set(programs.of(cell).NUMBERS)
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(importlib.import_module(
            f"portbench.metrics.{m['name']}").read)
    importlib.import_module(f"portbench.datasets.{cell.data['kind']}")
    for targets in cell.config.get("spans", {}).values():
        for target in targets:
            mod, attr = target.split(":")
            assert hasattr(importlib.import_module(mod), attr), target


def test_generators_repeat_for_a_seed_and_match_the_repository():
    from repro_torch.data.images import image_to_points, mandrill_like_image
    from repro_torch.data.synth import gaussian_blobs

    seed = 2 ** 31 + 7
    blobs = {"kind": "gaussian_blobs", "n": 3000, "clusters": 16,
             "spread": 0.5, "box": 10.0, "dim": 3}
    img = {"kind": "mandrill_image", "h": 103, "w": 103}
    for data in (blobs, img):
        a, b = loadgen.make_pool(data, 2, seed), loadgen.make_pool(data, 2,
                                                                    seed)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert a[0].dtype == np.float32 and not np.array_equal(a[0], a[1])
        assert not np.array_equal(a[0], loadgen.make_pool(data, 1,
                                                          seed + 1)[0])
    s = loadgen.input_seed(seed, 1)
    assert np.array_equal(loadgen.make_pool(img, 2, seed)[1],
                          image_to_points(mandrill_like_image(seed=s)))
    assert np.array_equal(loadgen.make_pool(blobs, 2, seed)[1],
                          gaussian_blobs(n=3000, k=16, dim=3, seed=s,
                                         spread=0.5)[0])


def test_roofline_counts_match_the_hand_checked_values():
    assert roofline.sweep_bytes("dense", 10609, 3) == pytest.approx(
        5.853e9, rel=1e-3)
    assert roofline.sweep_bound_s("dense", 10609, 3) == pytest.approx(
        1.747e-3, rel=1e-3)
    assert roofline.sweep_bytes("topk", 200_000, 3, 64) == pytest.approx(
        0.728e9, rel=1e-9)
    assert roofline.sweep_bound_s("topk", 200_000, 3, 64) == pytest.approx(
        0.2173e-3, rel=1e-3)
    assert roofline.topk_build_bound_s(200_000, 2, 64) == pytest.approx(
        0.97e-3, rel=1e-3)
    assert roofline.topk_build_bound_s(200_000, 128, 64) == pytest.approx(
        62.1e-3, rel=1e-3)


def test_a_run_without_a_card_fails_and_prints_no_result(monkeypatch,
                                                         capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["blobs-200k-topk.d2",
                                  "mandrill-dense.median"])
def test_a_cpu_run_gives_the_contract_keys(name, trace):
    cell = _tiny.tiny_cell(name)
    out = run.run_cell(cell, 2 ** 31 + 3, 0.0, bool(trace), "cpu",
                       time.perf_counter())
    dev = {"platform": "gpu", "kind": "test", "count": 1,
           "memory_peak_bytes": 1}
    with redirect_stdout(io.StringIO()):
        line = run.result_line(out, dev, bool(trace))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == {"mismatch"}
    want = cell.per_layer if trace else cell.end_to_end
    if trace:
        assert "engine_self_ms" in line["metrics"]
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert {"solve_s", "setup_s"} <= set(line["metrics"])
    assert set(line["metrics"]) <= {m["name"] for m in want}
    json.dumps(line)


def test_nothing_of_jax_is_loaded_by_a_run_or_the_reference(tmp_path):
    import subprocess
    import sys

    root = Path(spec.ROOT)
    env_path = f"{root}:{root / 'src'}"
    run_code = (
        "import time, json; from portbench import _tiny, run; "
        "run.run_cell(_tiny.tiny_cell('blobs-200k-topk.d2'), 5, 0.0, True,"
        " 'cpu', time.perf_counter()); "
        "print(json.dumps(run.forbidden_modules()))")
    ref_code = (
        "import sys, json, portbench.reference, portbench.programs.solve, "
        "portbench.reference.lm_dense, portbench.counts.lm_dense; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'})))")
    for code in (run_code, ref_code):
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=120, cwd=tmp_path, check=True,
            env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin",
                 "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"})
        assert json.loads(out.stdout.strip().splitlines()[-1]) == []
