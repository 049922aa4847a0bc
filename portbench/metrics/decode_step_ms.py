"""decode_step_ms: device time of the kernels launched inside the decode
spans (the engine's ``model_apply`` in decode mode), over the decode
steps run (each call runs ``new`` of them), in ms."""


def read(r):
    steps = r.calls * r.shapes.get("new", 0)
    if steps == 0 or not r.has("decode"):
        return None
    ns = r.device_in("decode")
    return ns / 1e6 / steps if ns else None
