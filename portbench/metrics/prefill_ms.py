"""prefill_ms: device time of the kernels launched inside the prefill
spans (the engine's ``model_apply`` in prefill mode), a call, in ms: the
mean over the traced calls, whose prompt lengths follow the mix's
inputs in turn."""


def read(r):
    if r.calls == 0 or not r.has("prefill"):
        return None
    ns = r.device_in("prefill")
    return ns / 1e6 / r.calls if ns else None
