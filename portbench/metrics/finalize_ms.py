"""finalize_ms: host time of the program's ``finalize`` span
(``engine._finalize``: the exemplars' copy to the host, their
canonicalisation, the labels and counts), a call, in ms."""
from portbench import program


def read(r):
    p = program.of(r)
    if p is None or r.calls == 0 or "finalize" not in p.host_ns:
        return None
    return p.host_ns["finalize"] / 1e6 / r.calls
