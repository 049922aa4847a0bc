"""host_syncs_per_solve: the synchronising runtime calls
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, synchronous ``cudaMemcpy``) made inside the
program's ``solve`` spans, a call: each one a wait of the host for the
device."""
from portbench import program


def read(r):
    p = program.of(r)
    if p is None or r.calls == 0 or not p.on_device:
        return None
    return p.syncs / r.calls
