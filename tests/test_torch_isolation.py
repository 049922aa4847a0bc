"""The port stands alone: no module of ``repro_torch`` (and not
``chip_smoke.py``) imports ``jax`` or the reference package ``repro``, and
neither does a rank that ``repro_torch.sharding.dist.spawn`` starts."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_solver_loads_no_jax():
    code = ("import sys, repro_torch.solver, repro_torch.kernels.ops, "
            "repro_torch.convert, repro_torch.data, "
            "repro_torch.solver.backends, repro_torch.kernels.topk_build, "
            "repro_torch.core.streaming, repro_torch.solver.compiled, "
            "repro_torch.solver.coarsen, repro_torch.graph, "
            "repro_torch.graph.edges, repro_torch.graph.affinity, "
            "repro_torch.checkpoint, repro_torch.checkpoint.ckpt, "
            "repro_torch.runtime, repro_torch.runtime.faultinject, "
            "repro_torch.solver.checkpointing, repro_torch.sharding.dist, "
            "repro_torch.core.mrhap, repro_torch.launch.cluster, "
            "repro_torch.launch.mesh, repro_torch.solver.topk_sharded, "
            "repro_torch.baselines, repro_torch.baselines.hkmeans, "
            "repro_torch.data.pipeline, repro_torch.core.expert_affinity, "
            "repro_torch.configs, repro_torch.models, repro_torch.serve, "
            "repro_torch.serve.kvcache, repro_torch.launch.serve, "
            "repro_torch.train, repro_torch.runtime.compression, "
            "repro_torch.runtime.fault, repro_torch.launch.train, "
            "repro_torch.runtime.elastic, repro_torch.sharding.partitioning, "
            "repro_torch.launch.dryrun, repro_torch.launch.hlo_cost, "
            "repro_torch.launch.hlo_analysis, "
            "repro_torch.models.layers.moe;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')];"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _loaded_reference_modules():
    """In a spawned rank: import the distributed modules, run a collective,
    and list what of jax or repro the process holds."""
    import repro_torch.baselines  # noqa: F401
    import repro_torch.core.mrhap  # noqa: F401
    import repro_torch.launch.cluster  # noqa: F401
    import repro_torch.solver.backends  # noqa: F401
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.sharding import dist

    import torch

    dist.psum(torch.ones(3), make_worker_mesh().axis("workers"))
    return [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_spawned_ranks_load_no_jax():
    from repro_torch.sharding import dist

    assert dist.spawn(_loaded_reference_modules, 2) == [[], []]
