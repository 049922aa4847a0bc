"""Build and load the CUDA kernels in ``repro_torch/csrc``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 --fmad=false
         -Xptxas -v -Xcompiler -fPIC -c csrc/<name>.cu
    nvcc -shared -o build/repro_torch_kernels/libkernels.so *.o

The library goes to ``build/repro_torch_kernels/`` at the root of the
checkout and is rebuilt whenever the sources or flags change (a content
hash and nvcc's ptxas report are kept beside it). Building happens on
first use, never at import, so machines without ``nvcc`` can import every
module. A failed build raises with nvcc's messages.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "libkernels.so"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                 "-std=c++17", "--fmad=false", "-Xptxas", "-v",
                 "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "repro_similarity": ([_P, _P, _P, _I64, _I64, ctypes.c_int, _P],
                         ctypes.c_int),
    "repro_responsibility": ([_P, _P, _P, _P, _P, _I64, _I64, _F, _F, _P],
                             ctypes.c_int),
    "repro_availability": ([_P, _P, _P, _P, _P, _P, _I64, _F, _F, _P],
                           ctypes.c_int),
    "repro_availability_scratch": ([_I64], _I64),
    "repro_topk_build": ([_P, _P, _P, _P, _I64, ctypes.c_int, ctypes.c_int,
                          _P], ctypes.c_int),
    "repro_topk_build_scratch": ([_I64, ctypes.c_int], _I64),
    "repro_flash_attention": ([_P, _P, _P, _P, _I64, _I64, _I64,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
                              ctypes.c_int),
    "repro_median_select": ([_P, _I64, _I64, ctypes.c_int, _I64, _I64,
                             ctypes.c_int, _P, _P, _P], ctypes.c_int),
    "repro_median_select_scratch": ([], _I64),
    "repro_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


class BuildInfo(NamedTuple):
    seconds: float        # wall time of this process's build (0 if cached)
    cached: bool
    ptxas: dict           # source name -> nvcc's -Xptxas -v lines (kept
                          # beside the library, so a cached build has them)


_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None
#: one loader at a time: the serving path's worker threads may all reach
#: their first launch together
_LIB_LOCK = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from repro_torch/csrc on first use")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _ptxas_lines(stderr: str) -> list[str]:
    # the stack/spill figures follow each "Function properties" line on a
    # line of their own, without the "ptxas" prefix
    return [ln.strip() for ln in stderr.splitlines()
            if "ptxas" in ln or "spill" in ln]


def _compile(out_dir: Path) -> dict:
    """Compile every source in parallel, then link; returns ptxas lines."""
    exe = nvcc()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [exe, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    ptxas, failures = {}, []
    for src, _, proc in procs:
        out, err = proc.communicate()
        ptxas[src.name] = _ptxas_lines(err)
        if proc.returncode != 0:
            failures.append(f"--- {src.name} (exit {proc.returncode})\n"
                            f"{out}{err}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    link = subprocess.run(
        [exe, "-shared", "-o", str(out_dir / LIB_NAME),
         *(str(obj) for _, obj, _ in procs)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    return ptxas


def build() -> BuildInfo:
    """Build the library unless an up-to-date one exists; safe to call
    from several processes at once (they serialise on a lock file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    stamp, report = BUILD_DIR / "digest", BUILD_DIR / "ptxas.json"
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (BUILD_DIR / LIB_NAME).is_file() and stamp.is_file() \
                and report.is_file() and stamp.read_text() == digest:
            return BuildInfo(0.0, True, json.loads(report.read_text()))
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            ptxas = _compile(Path(tmp))
            os.replace(Path(tmp) / LIB_NAME, BUILD_DIR / LIB_NAME)
        report.write_text(json.dumps(ptxas))
        stamp.write_text(digest)
        return BuildInfo(time.perf_counter() - t0, False, ptxas)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib, _info
    with _LIB_LOCK:
        if _lib is None:
            _info = build()
            handle = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = handle
    return _lib


def build_info() -> Optional[BuildInfo]:
    """What the build done by ``lib()`` in this process reported."""
    return _info


def check(err: int, kernel: str) -> None:
    """Raise if an entry point returned a non-zero cudaError_t."""
    if err != 0:
        msg = lib().repro_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err} "
                           f"({msg})")
