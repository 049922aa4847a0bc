#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

env       torch and CUDA versions, the card, TF32 switched off
build     nvcc builds every kernel in ``src/repro_torch/csrc`` (seconds,
          ptxas registers / shared memory / spills per kernel)
kernels   each kernel against its plain PyTorch version on the card, at the
          main path's shape (N = 10,609) and a ragged one (N = 4,099,
          d = 64), on random and on integer-valued (tie-heavy) inputs,
          and responsibility and availability also on a real HAP state
          (the Mandrill solve after 5 plain sweeps); availability bit for
          bit against the plain version summed in the kernel's order, and
          on inputs where both branches of Eq 2.2 occur off the diagonal;
          kernel, plain and bound times
solve     ``solve(x, backend="dense_fused")`` on the paper's Mandrill image
          at full resolution (103 x 103 pixels -> N = 10,609, d = 3; 3
          levels, 50 sweeps), fixed and converged stopping, held against
          the plain PyTorch path (``dense_parallel``) on the same card; the
          kernels' launch counts over the main-path call; auto-select on
          CUDA
launches  the launch counts of the main-path call
profile   only with ``--profile``: a ``torch.profiler`` trace of a 10-sweep
          ``dense_fused`` solve, device time by kernel and the device's
          idle share

Then the card's name and power limit as nvidia-smi prints them, the
kernels line ``{"kernels": [...]}``, and last ``{"ok": true, "device":
{...}}``. Any failed check exits non-zero with the traceback and without
the last line; so does a machine without a CUDA device, or a directory
without the repository's ``src/``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_MAIN = 10_609          # 103 x 103 pixels
N_RAGGED, D_RAGGED = 4_099, 64
LAM = 0.7                # SolveConfig().damping
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
FP32_OPS_PER_S = 67e12       # H100 SXM FP32 outside the tensor cores
MAX_MISMATCH = 1e-3      # share of points whose exemplar may differ
DEVICE = "cuda"


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ kernels
HAP_SWEEPS = 5           # sweeps before the state the "hap" cases take
HAP_LEVEL = 1            # middle level: finite tau, non-zero c and phi
MIN_BRANCH_SHARE = 0.01  # off-diagonal share each branch of Eq 2.2 needs
MAX_TOL_SHARE = 1e-3     # median tolerance / median |output|, at most


def hap_operands(x) -> dict:
    """The operands the responsibility and availability kernels take at
    level HAP_LEVEL in sweep HAP_SWEEPS + 1 of a plain default solve of
    ``x``: a real HAP state, whose column sums are small enough that both
    branches of Eq 2.2 occur off the diagonal."""
    from repro_torch.core import hap
    from repro_torch.core.preferences import median_preference
    from repro_torch.core.similarity import set_preferences, stack_levels
    from repro_torch.kernels import similarity
    from repro_torch.solver.dense import run_dense

    s = similarity.plain(x, x)
    s3 = stack_levels(set_preferences(s, median_preference(s)), 3)
    state = run_dense(s3, order="parallel", max_iterations=HAP_SWEEPS,
                      damping=LAM)[0]
    taken = {}

    def update_r(s, a, tau, r):
        taken["responsibility"] = tuple(
            t[HAP_LEVEL].clone() for t in (s, a, tau, r))
        return LAM * r + (1.0 - LAM) * hap.rho_update(s, a, tau)

    def update_a(r, c, phi, a):
        taken["availability"] = tuple(
            t[HAP_LEVEL].clone() for t in (r, c, phi, a))
        return a

    hap.jacobi_sweep(state, False, lam=LAM, kappa=0.0, s_mode="off",
                     update_r=update_r, update_a=update_a)
    return taken


def kernel_cases(x_pixels) -> list[dict]:
    """Each case: the kernel's wrapper call, its plain version, the
    version it must equal bit for bit (or None), the elementwise tolerance
    against the plain version (None: bit-identical), bytes and operations.
    """
    from repro_torch.kernels import availability, responsibility, similarity

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev).float()

    cases = []
    for n, d in ((N_MAIN, 3), (N_RAGGED, D_RAGGED)):
        ints = (x_pixels if n == N_MAIN else randint(0, 256, n, d))
        for kind, x in (("integer", ints), ("random", randn(n, d))):
            exact = kind == "integer"   # partial sums < 2**24: exact
            cases.append(dict(
                name="similarity", case=f"n={n},d={d},{kind}",
                kernel=lambda x=x: similarity.neg_sqeuclidean(x, x),
                plain=lambda x=x: similarity.plain(x, x),
                exact=(lambda x=x: similarity.plain(x, x)) if exact else None,
                tol=None if exact else
                (lambda want, x=x: similarity.tolerance(x, x)),
                nbytes=4 * (2 * n * d + n * n), ops=n * n * (2 * d + 4)))
    for n in (N_MAIN, N_RAGGED):
        hap = hap_operands(x_pixels[:n])
        for kind in ("random", "ties", "hap"):
            if kind == "hap":
                s, a, tau, r_old = hap["responsibility"]
            elif kind == "ties":   # integer-valued: duplicated row maxima
                s, a = -randint(0, 4, n, n), randint(-2, 3, n, n)
                r_old, tau = randn(n, n), randn(n)
            else:
                s, a = -10 * torch.rand(n, n, generator=g, device=dev), \
                    randn(n, n)
                r_old, tau = randn(n, n), randn(n)
            args = (s, a, tau, r_old, LAM)
            cases.append(dict(
                name="responsibility", case=f"n={n},{kind}",
                kernel=lambda args=args: responsibility.responsibility(*args),
                plain=lambda args=args: responsibility.plain(*args),
                exact=lambda args=args: responsibility.plain(*args),
                tol=None, nbytes=4 * (4 * n * n + n), ops=8 * n * n))
        for kind in ("random", "ties", "hap"):
            if kind == "hap":
                r, c, phi, a_old = hap["availability"]
            elif kind == "ties":
                # integers, so every partial sum is exact: mostly negative,
                # about 4 positive entries per column, so col_j is O(10)
                r = torch.where(
                    torch.rand(n, n, generator=g, device=dev) < 4.0 / n,
                    randint(1, 4, n, n), randint(-8, 1, n, n))
                c, phi, a_old = randint(-6, 2, n), randint(-6, 2, n), \
                    randint(-3, 4, n, n)
            else:
                # mostly negative, as responsibilities are: col_j is O(1)
                r = randn(n, n) - 3.0
                c, phi, a_old = randn(n), randn(n), randn(n, n)
            args = (r, c, phi, a_old, LAM)
            cases.append(dict(
                name="availability", case=f"n={n},{kind}",
                kernel=lambda args=args: availability.availability(*args),
                plain=lambda args=args: availability.plain(*args),
                exact=lambda args=args: availability.in_kernel_order(*args),
                tol=None if kind == "ties" else
                (lambda want, args=args: availability.tolerance(
                    *args[:3], LAM, want)),
                branches=lambda args=args: eq22_branch_shares(*args[:3]),
                nbytes=4 * (3 * n * n + 2 * n), ops=7 * n * n))
        del hap
    return cases


def eq22_branch_shares(r, c, phi) -> dict:
    """Shares of the off-diagonal entries where Eq 2.2's min(0, .) takes
    the sum (negative) and where it takes 0."""
    from repro_torch.kernels import availability
    fresh = availability.plain(r, c, phi, torch.zeros_like(r), 0.0)
    off = ~torch.eye(r.shape[0], dtype=torch.bool, device=r.device)
    n_off = float(off.sum())
    return {"negative": float(((fresh < 0) & off).sum()) / n_off,
            "zero": float(((fresh == 0) & off).sum()) / n_off}


def sampled_median(t: torch.Tensor) -> float:
    return float(t.flatten()[::101].median())


def check_case(cs: dict) -> tuple[dict, float]:
    """Run one kernel case and check it; returns its line and error."""
    name, case = cs["name"], cs["case"]
    got = cs["kernel"]()
    again = cs["kernel"]()
    want = cs["plain"]()
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{name} {case}: re-run differs")
    err = float((got - want).abs().max())
    line = {"phase": "kernels", "kernel": name, "case": case,
            "max_abs_err": err}
    if cs["exact"] is not None:
        check(torch.equal(got, cs["exact"]()),
              f"{name} {case}: differs from its exact version")
        line["bit_identical_to"] = ("plain" if name != "availability"
                                    else "in_kernel_order")
    if cs["tol"] is None:
        line["tolerance"] = "0 (bit-identical to plain)"
        check(torch.equal(got, want),
              f"{name} {case}: not bit-identical, max err {err}")
    else:
        tol = cs["tol"](want)
        share = sampled_median(tol) / sampled_median(want.abs())
        line["tolerance"] = (f"<= {name}.tolerance elementwise "
                             f"(largest {float(tol.max()):.3g}, median "
                             f"{share:.3g} of the median |output|)")
        check(bool(((got - want).abs() <= tol).all()),
              f"{name} {case}: error {err} beyond tolerance")
        check(share <= MAX_TOL_SHARE,
              f"{name} {case}: tolerance {share:.3g} of a typical output "
              "is too loose to fail a wrong kernel")
    if "branches" in cs:
        shares = cs["branches"]()
        line["eq22_off_diagonal"] = shares
        check(min(shares.values()) >= MIN_BRANCH_SHARE,
              f"{name} {case}: inputs leave a branch of Eq 2.2 untested: "
              f"{shares}")
    return line, err


def run_kernels(x_pixels) -> dict:
    summary = {name: {"max_abs_err": 0.0}
               for name in ("similarity", "responsibility", "availability")}
    for cs in kernel_cases(x_pixels):
        name = cs["name"]
        line, err = check_case(cs)
        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], err)
        if cs["case"].startswith(f"n={N_MAIN},") and "plain_ms" not in \
                summary[name]:
            k_ms = cuda_ms(cs["kernel"], iters=20)
            p_ms = cuda_ms(cs["plain"], iters=5, warmup=1)
            b_ms, b_by = bound_ms(cs["nbytes"], cs["ops"])
            summary[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None)
            line.update(kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None,
                        library="none" if name != "similarity" else
                        "none: torch.cdist gives the distance's root, so "
                        "-cdist(x, y)**2 takes two calls")
        emit(line)
    return summary


# -------------------------------------------------------------------- solve
def run_solve(x) -> dict:
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solver import solve

    n = x.shape[0]
    launches = None
    for stop in ("fixed", "converged"):
        res = {}
        for backend in ("dense_fused", "dense_parallel"):
            solve(x, backend=backend, stop=stop, device=DEVICE)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            r = solve(x, backend=backend, stop=stop, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            res[backend] = r
            emit({"phase": "solve", "backend": backend, "stop": stop,
                  "n": n, "levels": r.levels, "wall_s": wall,
                  "n_sweeps": r.n_sweeps, "converged": r.converged,
                  "n_clusters": r.n_clusters.tolist(),
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "launches": counts})
            check(r.exemplars.shape == (r.levels, n)
                  and r.exemplars.min() >= 0 and r.exemplars.max() < n,
                  f"{backend} {stop}: exemplars out of range")
            if backend == "dense_fused":
                sweeps = r.levels * r.n_sweeps
                check(counts == {"similarity": 1, "responsibility": sweeps,
                                 "availability": sweeps},
                      f"dense_fused {stop}: launches {counts}, expected "
                      f"similarity 1 and {sweeps} per update")
                if stop == "fixed":
                    launches = counts        # the main path's run
            else:
                check(not any(counts.values()),
                      f"dense_parallel launched kernels: {counts}")
        f, p = res["dense_fused"], res["dense_parallel"]
        mismatch = float((f.exemplars != p.exemplars).mean())
        emit({"phase": "solve", "compare": stop,
              "exemplar_mismatch": mismatch,
              "n_clusters_equal": bool((f.n_clusters
                                        == p.n_clusters).all()),
              "trace_equal": bool(np.array_equal(f.trace, p.trace))})
        check((f.n_clusters == p.n_clusters).all(),
              f"{stop}: cluster counts differ {f.n_clusters} "
              f"vs {p.n_clusters}")
        check(mismatch <= MAX_MISMATCH,
              f"{stop}: {mismatch:.2%} of exemplars differ")
        check(np.array_equal(f.trace, p.trace)
              and f.n_sweeps == p.n_sweeps and f.converged == p.converged,
              f"{stop}: traces differ")

    auto = solve(x[:8000], device=DEVICE)
    emit({"phase": "solve", "auto_select_n": 8000, "backend": auto.backend})
    check(auto.backend == "dense_fused",
          f"auto-select on CUDA chose {auto.backend}")
    return launches


def run_profile(pixels) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.solver import solve
    kw = dict(backend="dense_fused", max_iterations=10, device=DEVICE)
    solve(pixels, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(pixels, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only (kernels, copies): the host-side aten ops
    # report their kernels' time again as their own device time
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  reverse=True)
    busy = sum(us for us, _, _ in rows) / 1e6
    emit({"phase": "profile", "sweeps": 10, "wall_s": wall,
          "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
          "top": [{"name": k[:90], "calls": c, "device_ms": us / 1e3}
                  for us, c, k in rows[:20]]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a short fused solve with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.data import image_to_points, mandrill_like_image
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    _build.lib()
    info = _build.build_info()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "cached": info.cached, "ptxas": info.ptxas})

    pixels = image_to_points(mandrill_like_image(103, 103))
    x = torch.from_numpy(pixels).to(DEVICE)
    summary = run_kernels(x)
    launches = run_solve(pixels)
    emit({"phase": "launches", "launches": launches})
    if args.profile:
        run_profile(pixels)

    kernels = []
    for name, fn_line in (("similarity", "similarity.py:35"),
                          ("responsibility", "responsibility.py:71"),
                          ("availability", "availability.py:68")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{fn_line}",
            "launches": launches[name], **summary[name]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
