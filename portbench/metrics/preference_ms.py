"""preference_ms: device time of the kernels launched inside the
preference spans, a call, in ms."""


def read(r):
    if r.calls == 0 or not r.has("preference"):
        return None
    ns = r.device_in("preference")
    return ns / 1e6 / r.calls if ns else None
