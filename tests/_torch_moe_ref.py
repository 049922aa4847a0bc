"""The reference's sharded MoE dispatch (``moe_apply`` under a 2 x 2
(data, model) mesh, i.e. ``_moe_sharded``) on 4 forced host devices, for
``tests/test_torch_moe_sharded.py``; run as a script so that the forced
device count stays out of the test process:

    python tests/_torch_moe_ref.py IN.npz OUT.npz

IN holds ``router, gate, up, down, x`` and the scalars ``top_k``,
``capacity_factor``; OUT gets ``y``, ``aux`` and, for each data block d
and model rank m, ``keep_d{d}_m{m}``: which (token, choice) pairs of the
block the rank keeps, from the reference's own ``_route_and_dispatch``
with the arguments its ``shard_map`` body gives it.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.layers.moe import _route_and_dispatch, moe_apply  # noqa
from repro.sharding.compat import make_mesh, set_mesh  # noqa: E402


def main(src: str, dst: str) -> int:
    z = np.load(src)
    p = {k: jnp.asarray(z[k]) for k in ("router", "gate", "up", "down")}
    x = jnp.asarray(z["x"])
    top_k, cf = int(z["top_k"]), float(z["capacity_factor"])
    mesh = make_mesh((2, 2), ("data", "model"))
    with set_mesh(mesh):
        out = jax.jit(lambda p, x: moe_apply(
            p, x, top_k=top_k, capacity_factor=cf))(p, x)
    res = {"y": np.asarray(out.y), "aux": np.asarray(out.aux_loss)}
    e = p["router"].shape[-1]
    b, s, d = x.shape
    t = b // 2 * s
    cap = max(4, int(math.ceil(t * top_k / e * cf)))
    for di in range(2):
        xt = x[di * b // 2:(di + 1) * b // 2].reshape(t, d)
        for m in range(2):
            e_loc = e // 2 if e % 2 == 0 else e
            e_lo = m * e_loc if e % 2 == 0 else 0
            _, (inv, _, _, _) = _route_and_dispatch(
                xt, p["router"], top_k, e, e_lo, e_loc, cap)
            res[f"keep_d{di}_m{m}"] = np.asarray(inv) != e_loc * cap
    np.savez(dst, **res)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
