#!/usr/bin/env python3
"""Time the fused top-k kernel against variants of itself on one card.

    python3 tools/topk_levers.py

Each variant is ``src/repro_torch/csrc/topk_build.cu`` with one design
choice undone (the text substitutions below), built by nvcc into a
temporary directory outside the checkout. On the 200,000 blobs (d = 2) and
the 512 x 512 Mandrill pixels (d = 3), k = 64, every variant is timed with
CUDA events in turns (each variant once, then again in reverse order) and
checked bit for bit against the committed kernel, except ``fast_path_only``,
a diagnostic that never inserts (it times the pairs' arithmetic, loads and
votes alone). Commit 4608d21's kernel is timed too when ``chip_smoke``
can build it. Prints one JSON line per case; needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ROWS = "return D <= 3 ? 2 : (D <= 7 ? 2 : 1);"
VARIANTS = {
    "committed": [],
    # columns in ascending order from 0, no wrap (design point 5)
    "ascending": [("const int a0 = row0 / PSTEP * PSTEP;",
                   "const int a0 = 0;")],
    # 4 or 1 rows a warp at d <= 3 (design point 1)
    "rows4": [(ROWS, "return D <= 3 ? 4 : (D <= 7 ? 2 : 1);")],
    "rows1": [(ROWS, "return D <= 3 ? 1 : (D <= 7 ? 2 : 1);")],
    # 2 groups of 32 columns a step instead of 4
    "groups2": [("constexpr int PC = 4; ", "constexpr int PC = 2; ")],
    # 4 or 16 warps a block instead of 8: fewer or more warps read each
    # column stream through L1 (design point 1)
    "warps4": [("constexpr int PW = 8; ", "constexpr int PW = 4; ")],
    "warps16": [("constexpr int PW = 8; ", "constexpr int PW = 16; ")],
    # diagnostic: the vote never opens the slow path (no insertion)
    "fast_path_only": [(
        "      if (!__any_sync(FULL, pass)) continue;\n"
        "      const int col = c0 + g * 32 + lane;",
        "      if (__ballot_sync(FULL, pass) != 0xdead0000u\n"
        "          + static_cast<unsigned>(k)) continue;\n"
        "      const int col = c0 + g * 32 + lane;")],
}


def build(tmp: Path) -> dict:
    from repro_torch.kernels import _build

    src = (_build.CSRC / "topk_build.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"{name}: the source no longer has {a!r}")
            text = text.replace(a, b)
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.COMPILE_FLAGS, "-I", str(_build.CSRC),
             "-shared", "-o", str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{err}")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn in ("repro_topk_build", "repro_topk_build_scratch"):
            args, res = _build._SIGNATURES[fn]
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        libs[name] = lib
    return libs


def runner(lib):
    from repro_torch.kernels.topk_similarity import _by_column

    def run(x, k):
        n, d = x.shape
        vals = torch.empty((n, k), device=x.device)
        idx = torch.empty((n, k), dtype=torch.int32, device=x.device)
        scratch = torch.empty(lib.repro_topk_build_scratch(n, d),
                              device=x.device)
        err = lib.repro_topk_build(x.data_ptr(), scratch.data_ptr(),
                                   vals.data_ptr(), idx.data_ptr(), n, d, k,
                                   torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"launch failed: {err}")
        return _by_column(vals, idx)
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("topk_levers: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.data import (
        gaussian_blobs, image_to_points, mandrill_like_image,
    )
    from repro_torch.kernels import topk_build

    print(cs.nvidia_smi(), flush=True)
    runs = {name: runner(lib)
            for name, lib in build(Path(tempfile.mkdtemp())).items()}
    base, origin = cs.baseline_topk()
    if base is not None:
        runs["commit_4608d21"] = base
    order = list(runs) + list(runs)[::-1]
    for case, pts in (
            ("blobs", gaussian_blobs(n=cs.N_BLOBS, k=16, seed=0,
                                     spread=0.5)[0]),
            ("pixels_512", image_to_points(mandrill_like_image(512, 512)))):
        x = torch.from_numpy(pts).to("cuda")
        want = topk_build.topk_similarity_fused(x, cs.K_TOPK)
        line = {"case": case, "n": x.shape[0], "d": x.shape[1],
                "k": cs.K_TOPK, "ms": {}, "bit_identical": {}}
        for name in order:
            run = runs[name]
            got = run(x, cs.K_TOPK)
            line["bit_identical"][name] = bool(
                torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
            line["ms"].setdefault(name, []).append(
                cs.cuda_ms(lambda: run(x, cs.K_TOPK), iters=3, warmup=1))
        print(json.dumps(line), flush=True)
        for name, same in line["bit_identical"].items():
            cs.check(same or name == "fast_path_only",
                     f"{case}: {name} selects other edges")
        del x, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
