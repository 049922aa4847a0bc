"""kernels_per_sweep: device operations launched inside the program's four
phase spans of a sweep (``sweep.r``, ``sweep.a``, ``sweep.levels``,
``sweep.assign``), over the sweeps run."""
from portbench import program


def read(r):
    p = program.of(r)
    if p is None or r.sweeps == 0:
        return None
    n = sum(p.device_ops.get(phase, 0) for phase in program.PHASES)
    return n / r.sweeps if n else None
