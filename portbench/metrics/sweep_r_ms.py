"""sweep_r_ms: device time of the kernels launched inside the program's
``sweep.r`` spans, the responsibility update (``update_r`` in
``hap.jacobi_sweep``), over the sweeps run, in ms."""
from portbench import program


def read(r):
    return program.phase_ms(r, "sweep.r")
