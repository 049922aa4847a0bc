"""build_ms: device time of the kernels launched inside the build spans
and outside the preference spans nested in them, a call, in ms."""


def read(r):
    if r.calls == 0 or not r.has("build"):
        return None
    ns = r.device_in("build", without=("preference",))
    return ns / 1e6 / r.calls if ns else None
