"""host_copies_per_solve: the program's ``host_copies.*`` counters (every
explicit copy between host and device on the solve path, through
``repro_torch.obs.to_host`` and ``to_device``) over its ``solves``
counter: a solve's copies, over every solve the process made (the
warm-up's and the window's)."""
from portbench import program


def read(r):
    c = program.counters()
    if c is None or not c.get("solves"):
        return None
    return sum(v for k, v in c.items()
               if k.startswith("host_copies.")) / c["solves"]
