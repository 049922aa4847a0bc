"""The port stands alone: no module of ``repro_torch`` (and not
``chip_smoke.py``) imports ``jax`` or the reference package ``repro``."""
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
            "repro_torch.solver.checkpointing;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')];"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
