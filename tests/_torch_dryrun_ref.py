"""The reference dry run's parameter and FLOP accounting for every
(architecture, shape) cell, for ``tests/test_torch_dryrun.py``; run as a
script, since importing ``repro.launch.dryrun`` forces 512 host devices:

    python tests/_torch_dryrun_ref.py OUT.json

OUT gets ``{arch: {"params_total", "params_active", "model_flops":
{shape: flops}}}`` from the reference's ``n_active_params`` and
``model_flops``.
"""
import json
import sys

from repro.configs import applicable_shapes, arch_names, get_arch
from repro.launch.dryrun import (
    _eval_shape_with_specs, model_flops, n_active_params,
)
from repro.models import model_init


def main(dst: str) -> int:
    out = {}
    for name in arch_names():
        cfg = get_arch(name)
        sds, _ = _eval_shape_with_specs(lambda k: model_init(k, cfg))
        total, active = n_active_params(cfg, sds)
        out[name] = {"params_total": total, "params_active": active,
                     "model_flops": {s.name: model_flops(cfg, s, active)
                                     for s in applicable_shapes(cfg)}}
    with open(dst, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
