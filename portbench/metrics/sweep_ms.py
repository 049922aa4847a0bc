"""sweep_ms: device time of the kernels launched inside the sweep spans,
over the sweeps run, in ms."""


def read(r):
    if r.sweeps == 0 or not r.has("sweep"):
        return None
    ns = r.device_in("sweep")
    return ns / 1e6 / r.sweeps if ns else None
