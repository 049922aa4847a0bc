"""sweep_levels_ms: device time of the kernels launched inside the
program's ``sweep.levels`` spans, the inter-level reductions (tau and c,
phi and its ``cat``, s_next, in ``hap.jacobi_sweep``), over the sweeps
run, in ms."""
from portbench import program


def read(r):
    return program.phase_ms(r, "sweep.levels")
