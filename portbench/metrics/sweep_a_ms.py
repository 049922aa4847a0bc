"""sweep_a_ms: device time of the kernels launched inside the program's
``sweep.a`` spans, the availability update (``update_a`` in
``hap.jacobi_sweep``), over the sweeps run, in ms."""
from portbench import program


def read(r):
    return program.phase_ms(r, "sweep.a")
