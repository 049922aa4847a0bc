"""sweep_assign_ms: device time of the kernels launched inside the
program's ``sweep.assign`` spans, the assignment and its change count
(``dense.drive_sweeps``), over the sweeps run, in ms."""
from portbench import program


def read(r):
    return program.phase_ms(r, "sweep.assign")
