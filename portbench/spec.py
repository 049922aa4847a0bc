"""``BENCHMARK.json`` and the files it names, resolved for one cell.

A cell (``workloads`` entry) names a configuration and a traffic mix.
The configuration's file is the one ``configs`` gives it, and its
``program`` key names the program that runs it
(``portbench/programs/<program>.py``; absent, ``solve``). The mix is
``portbench/mixes/<traffic>.json``, the cell's own limits
``portbench/cells/<cell>.json``, and each per-layer metric's reader
``portbench/metrics/<metric>.py``. A mix may add to the configuration's
``data`` parameters and ``solve`` overrides.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_PROGRAM = "solve"


class Cell(NamedTuple):
    name: str
    chips: int
    program: str          # the configuration's program
    config: dict          # the configuration file, as is
    mix: dict             # the traffic mix file, as is
    limits: dict          # number -> limit, from the cell's file
    data: dict            # generator parameters (config's, then mix's)
    solve: dict           # SolveConfig overrides (config's, then mix's)
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _load(Path(root) / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(by_name)}")
    w = by_name[name]
    root = Path(root)
    here = root / "portbench"
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load(root / conf["file"])
    mix = _load(here / "mixes" / f"{w['traffic']}.json")
    limits = _load(here / "cells" / f"{name}.json")["limits"]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in e2e_names and _reports(m, name)]
    return Cell(name=name, chips=w["chips"],
                program=config.get("program", DEFAULT_PROGRAM),
                config=config, mix=mix, limits=limits,
                data={**config["data"], **mix.get("data", {})},
                solve={**config.get("solve", {}), **mix.get("solve", {})},
                end_to_end=e2e, per_layer=per_layer)
