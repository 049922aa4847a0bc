"""engine_self_ms: the front door's own host time a call: the ``solve``
span less its child spans (routing, input normalisation, ``_finalize``'s
host copies and canonicalisation), in ms."""


def read(r):
    if r.calls == 0 or not r.has("solve"):
        return None
    return r.solve_self_ns / 1e6 / r.calls
