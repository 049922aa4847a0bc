"""The port's dry run (``launch/dryrun.py``) and its cost counter
(``launch/hlo_cost.py``) — the counterparts of ``tests/test_hlo_cost.py``
and of the reference dry run's accounting.

* ``python -m repro_torch.launch.dryrun --all --mesh both`` counts all
  64 cells (32 architecture x shape pairs on the 16 x 16 and 2 x 16 x 16
  meshes), the two MoE architectures included, and exits 0; its
  ``params_total``, ``params_active`` and ``model_flops`` equal the
  reference's ``n_active_params`` and ``model_flops`` exactly for all ten
  architectures at full size (``tests/_torch_dryrun_ref.py``, a
  subprocess: the reference's dry run forces 512 host devices).
* The counter on graphs with known answers, as the reference's tests
  check its HLO walker: a matmul's FLOPs and bytes, a loop of matmuls
  (the reference's scan with a trip count) and a nested one, and a slice
  update that counts the slice, not the buffer.
* The dry run's extrapolation over depth and length equals a count of the
  whole config (a train cell, and a blockwise prefill cut to five units).

``test_hlo_cost.py::test_parse_module_symbol_table`` has no counterpart:
there is no HLO text to parse.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hlo_cost import analyze, polynomial_fit  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


@pytest.fixture(scope="module")
def dry_all(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "all.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both", "--out", str(out)],
        env=ENV, capture_output=True, text=True, timeout=900)
    return proc, json.loads(out.read_text())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    subprocess.run([sys.executable, os.path.join(REPO, "tests",
                                                 "_torch_dryrun_ref.py"),
                    str(out)], env=ENV, check=True, timeout=600)
    return json.loads(out.read_text())


def test_all_cells_count_and_exit_0(dry_all):
    proc, res = dry_all
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert not res["failures"]
    cells = {(r["arch"], r["shape"], r["mesh"]) for r in res["results"]}
    assert len(cells) == 64
    assert "[dryrun] 64 cells counted, 0 failed" in proc.stdout
    keys = {"hlo_flops_per_chip", "hlo_bytes_per_chip",
            "collective_bytes_per_chip", "collective_by_type",
            "params_total", "params_active", "model_flops", "useful_ratio",
            "memory", "compute_s", "memory_s", "collective_s", "dominant",
            "count_s", "chips", "layout"}
    for r in res["results"]:
        assert keys <= set(r), r["arch"]
        assert "lower_s" not in r and "xla_cost_flops_once" not in r
        assert r["chips"] == (256 if r["mesh"] == "16x16" else 512)
        assert r["hlo_flops_per_chip"] > 0 and r["hlo_bytes_per_chip"] > 0
        assert r["collective_bytes_per_chip"] > 0
        assert r["memory"]["state_bytes"] > 0
        # the counted program repeats the dense compute on every model
        # rank, so its ratio is not the reference's: null, and the layout
        # named
        assert r["useful_ratio"] is None
        assert r["layout"] == dryrun.LAYOUT
        assert 0 < r["model_flops"] / (r["hlo_flops_per_chip"]
                                       * r["chips"]) < 1.5
        assert r["dominant"] in ("compute", "memory", "collective")


def _arch_names():
    from repro_torch.configs import arch_names
    return arch_names()


@pytest.mark.parametrize("arch", _arch_names())
def test_params_and_model_flops_equal_the_reference(dry_all, reference,
                                                    arch):
    _, res = dry_all
    want = reference[arch]
    rows = [r for r in res["results"] if r["arch"] == arch]
    assert {r["shape"] for r in rows} == set(want["model_flops"])
    for r in rows:
        assert r["params_total"] == want["params_total"]
        assert r["params_active"] == want["params_active"]
        assert r["model_flops"] == want["model_flops"][r["shape"]]


def test_moe_cells_take_the_sharded_dispatch(dry_all):
    """Expert-parallel qwen3 (128 experts over a 16-way model axis) sums
    its outputs over "model", so its cells' collectives include the MoE's
    sums, which grow with the tokens: more bytes a chip on the train cell
    than the gradient and parameter traffic alone would send."""
    _, res = dry_all
    row = {(r["arch"], r["shape"], r["mesh"]): r for r in res["results"]}
    q = row[("qwen3-moe-235b-a22b", "train_4k", "16x16")]
    assert q["collective_by_type"]["all-reduce"] > 0
    d1 = row[("qwen3-moe-235b-a22b", "decode_32k", "16x16")]
    d2 = row[("qwen3-moe-235b-a22b", "prefill_32k", "16x16")]
    # the same parameter gathers; the prefill's sums carry 32k tokens
    assert d2["collective_bytes_per_chip"] > d1["collective_bytes_per_chip"]


# ---------------------------------------------- the counter, analytically
def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_plain_matmul_flops_and_bytes():
    m, k, n = 384, 256, 128
    _, c = analyze(lambda a, b: a @ b, _meta(m, k), _meta(k, n))
    assert c.flops == 2.0 * m * k * n
    assert c.bytes == 4 * (m * k + k * n + m * n)


def test_loop_flops_multiplied_by_trip():
    n, d, iters = 256, 512, 7

    def f(x, w):
        for i in range(iters):
            x = torch.tanh(x @ w[i])
        return x

    _, c = analyze(f, _meta(n, d), _meta(iters, d, d))
    assert c.flops == 2.0 * n * d * d * iters
    assert c.elementwise == n * d * iters          # the tanh outputs


def test_nested_loop_multiplies():
    n = 128

    def f(x, w):
        for i in range(4):
            for _ in range(3):
                x = torch.tanh(x @ w[i])
        return x

    _, c = analyze(f, _meta(n, n), _meta(4, n, n))
    assert c.flops == 2.0 * n ** 3 * 3 * 4


def test_slice_update_counts_slice_not_buffer():
    buf_n, upd_n = 8192, 8

    def f(buf, upd, idx):
        buf[idx:idx + upd_n].copy_(upd)
        return buf

    _, c = analyze(f, _meta(buf_n, 128), _meta(upd_n, 128), 16)
    assert c.bytes < buf_n * 128 * 4 * 0.5
    assert c.bytes == 2 * upd_n * 128 * 4


def test_dry_collectives_count_what_they_would_send():
    from repro_torch.sharding import dist
    from repro_torch.sharding.partitioning import make_abstract_mesh
    mesh = make_abstract_mesh((4, 2), ("data", "model"))
    x = _meta(8, 16)
    _, c = analyze(lambda: dist.psum(dist.all_gather(
        x, mesh.axis("model")), mesh.axis("data")), traffic=mesh.traffic)
    assert c.wire_by_type == {"all-gather": 1 * 8 * 16 * 4,
                              "all-reduce": 3 * 16 * 16 * 4}
    assert c.collective_ops == 2


def test_polynomial_fit_is_exact_on_a_quadratic():
    from repro_torch.launch.hlo_cost import Cost

    def cost(s):
        v = 3.0 + 5.0 * s + 7.0 * s * s
        return Cost(v, 2 * v, s, v, {"all-gather": s}, 4)
    got = polynomial_fit({16: cost(16), 32: cost(32), 48: cost(48)}, 4096)
    assert got == cost(4096)


def _direct(cfg, shape):
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.models import pick_mode
    from repro_torch.sharding.partitioning import make_abstract_mesh
    mesh = make_abstract_mesh(*production_mesh_shape())
    fn = dryrun._train_cost if shape.kind == "train" else dryrun._serve_cost
    return fn(cfg, shape, mesh, pick_mode(cfg, shape.kind, shape.seq_len))


@pytest.mark.parametrize("cell", ["train", "blockwise prefill"])
def test_extrapolation_equals_the_whole_count(cell):
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.sharding.partitioning import make_abstract_mesh
    if cell == "train":
        cfg, shape = get_arch("tinyllama-1.1b"), SHAPES["train_4k"]
    else:
        cfg = dataclasses.replace(get_arch("internvl2-2b"), n_layers=5)
        shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=12288)
    fit = dryrun.count_cell(cfg, shape, make_abstract_mesh(
        *production_mesh_shape()))
    whole = _direct(cfg, shape)
    for f in ("flops", "bytes", "elementwise", "wire_bytes",
              "collective_ops"):
        assert math.isclose(getattr(fit, f), getattr(whole, f),
                            rel_tol=1e-12), f
