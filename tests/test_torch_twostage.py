"""The port's two-stage top-k build and kd partitioner on the CPU against
the JAX reference and against the port's reference scan.

* ``kd_median_cut`` / ``kd_cells`` are numpy copies: equal arrays.
* ``topk_similarity_twostage`` computes every similarity it keeps in the
  reference scan's fixed order (``kernels/topk_similarity.py``), so
  against the port's scan it must be bit-identical, values and columns,
  for every metric. Against the JAX two-stage build the columns must be
  equal; the values differ by the rounding of the similarity formula on
  each side (XLA contracts multiply-adds into FMAs and sums in its own
  order), bounded elementwise by ``_drift``: a squared distance that each
  side computes within (d + 2) eps (|x_i|^2 + |x_j|^2) of the exact value,
  carried through the metric (queue C of ``ROADMAP.md`` measured 1.3e-6
  between the reference's own two builds for neg_euclidean).
* Small ``chunk``, ``round_chunks``, ``max_rounds`` and
  ``residual_chunks`` make the bootstrap, the capped rounds and the
  residual slabs all run (checked through ``host_copies.twostage_build``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import gaussian_blobs  # noqa: E402
from repro.kernels import topk_similarity as j_sim  # noqa: E402
from repro.sharding import partitioning as j_part  # noqa: E402
from repro.solver.topk_build import (  # noqa: E402
    resolve_build_backend as j_resolve_build,
)
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import topk_similarity as p_sim  # noqa: E402
from repro_torch.sharding import partitioning as p_part  # noqa: E402
from repro_torch.solver import solve  # noqa: E402
from repro_torch.solver import topk_build  # noqa: E402

EPS = 2.0 ** -24
METRICS = ("neg_sqeuclidean", "neg_euclidean", "cosine")
SMALL = dict(block_rows=256, chunk=16, round_chunks=3, max_rounds=2,
             residual_chunks=8)


def _points(kind, n=2000, d=3, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((n, d)).astype(np.float32)
    x = rng.integers(0, 4, (n, d)).astype(np.float32)   # exact arithmetic
    x[n // 4:n // 2] = x[:n // 4]                        # duplicate points
    return x


def _drift(x, idx, want, metric):
    """Elementwise bound on |port - JAX| of the selected values."""
    d = x.shape[1]
    xx = (x.astype(np.float64) ** 2).sum(axis=1)
    if metric == "cosine":                 # unit vectors, plus the norms
        return np.full(want.shape, 4 * (d + 4) * EPS)
    delta = 2 * (d + 2) * EPS * (xx[:, None] + xx[idx])
    if metric == "neg_sqeuclidean":
        return delta
    # |sqrt(a) - sqrt(b)| <= min(|a - b| / sqrt(b), sqrt(|a - b|))
    return np.minimum(delta / np.maximum(np.abs(want), 1e-30),
                      np.sqrt(delta))


# ------------------------------------------------------------ partitioner
@pytest.mark.parametrize("n,d,leaf", [(517, 3, 64), (256, 2, 64), (40, 4, 64),
                                      (2000, 3, 16), (1000, 1, 7)])
def test_kd_partition_matches_reference(n, d, leaf):
    x = _points("integer" if d == 3 else "random", n, d, seed=n)
    perm, splits = p_part.kd_median_cut(x, leaf)
    j_perm, j_splits = j_part.kd_median_cut(x, leaf)
    np.testing.assert_array_equal(perm, j_perm)
    np.testing.assert_array_equal(splits, j_splits)
    assert perm.dtype == j_perm.dtype and splits.dtype == j_splits.dtype
    cells, j_cells = p_part.kd_cells(x, leaf), j_part.kd_cells(x, leaf)
    assert len(cells) == len(j_cells)
    for a, b in zip(cells, j_cells):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(p_sim.kd_order(x, leaf),
                                  j_sim.kd_order(x, leaf))


def test_kd_median_cut_validates_input():
    with pytest.raises(ValueError, match=r"\(N, d\)"):
        p_part.kd_median_cut(np.zeros((4,), np.float32), 2)
    with pytest.raises(ValueError, match="leaf"):
        p_part.kd_median_cut(np.zeros((4, 2), np.float32), 0)


# ------------------------------------------------------------------ build
@pytest.mark.parametrize("kind", ["random", "integer"])
@pytest.mark.parametrize("metric", METRICS)
def test_twostage_matches_scan_and_reference(metric, kind, monkeypatch):
    x = _points(kind)
    k = 10
    merges = []
    select = p_sim.topk_select_exact
    monkeypatch.setattr(p_sim, "topk_select_exact",
                        lambda *a: merges.append(1) or select(*a))
    obs.reset_counters("host_copies.twostage_build")
    got = p_sim.topk_similarity_twostage(torch.from_numpy(x), k,
                                         metric=metric, **SMALL)
    # 8 row blocks: the kd copy, then per block at most 2 rounds and 16
    # residual slabs read on the host; the merges past the bootstrap and
    # the 2 rounds of every block are residual slabs
    syncs = obs.counters()["host_copies.twostage_build"]
    assert 8 * 16 < syncs <= 1 + 8 * (2 + 16)
    assert len(merges) > 8 * 3
    scan = p_sim.topk_similarity(torch.from_numpy(x), k, metric=metric,
                                 block_rows=300, block_cols=700)
    assert torch.equal(got[0], scan[0]) and torch.equal(got[1], scan[1])
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    jv, ji = j_sim.topk_similarity_twostage(jnp.asarray(x), k,
                                            metric=metric, **SMALL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))
    err = np.abs(got[0].numpy() - np.asarray(jv))
    assert (err <= _drift(x, np.asarray(ji), np.asarray(jv), metric)).all()
    if kind == "integer" and metric != "cosine":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jv))


@pytest.mark.parametrize("k", [1, 40, 129])
def test_twostage_every_stage_and_k(k):
    """k across one, several and many cells; a row block that is not a
    multiple of the rows; default round and residual caps."""
    x = _points("integer", n=700, d=2, seed=k)
    got = p_sim.topk_similarity_twostage(torch.from_numpy(x), k,
                                         block_rows=96, chunk=8)
    want = p_sim.topk_similarity(torch.from_numpy(x), k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ji = j_sim.topk_similarity_twostage(jnp.asarray(x), k, block_rows=96,
                                        chunk=8)[1]
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))


def test_row_offset_splits_and_perm_reproduce_full_build():
    x = torch.from_numpy(_points("random", n=120, seed=9))
    full = p_sim.topk_similarity_twostage(x, 11, chunk=8)
    a = p_sim.topk_similarity_twostage(x[:50], 11, cols=x, row_offset=0,
                                       chunk=8)
    perm = np.random.default_rng(0).permutation(120)   # any order is exact
    b = p_sim.topk_similarity_twostage(x[50:], 11, cols=x, row_offset=50,
                                       chunk=8, perm=perm)
    assert torch.equal(full[1], torch.cat([a[1], b[1]]))
    assert torch.equal(full[0], torch.cat([a[0], b[0]]))


def test_twostage_rejects_what_the_reference_rejects():
    class FakeShape:
        shape = (1 << 25, 2)
    with pytest.raises(ValueError, match="N <= "):
        p_sim.topk_similarity_twostage(FakeShape(), 4)
    x = torch.zeros(10, 2)
    with pytest.raises(ValueError, match="k must be in"):
        p_sim.topk_similarity_twostage(x, 10)
    with pytest.raises(ValueError, match="unknown metric"):
        p_sim.topk_similarity_twostage(x, 3, metric="manhattan")


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("n", [32_767, 32_768])
def test_auto_build_routing_matches_reference(n):
    for k in (8, 64, 8192, 8193):
        for metric in METRICS:
            for platform, j_platform in (("cpu", "cpu"), ("cuda", "tpu")):
                assert topk_build.resolve_build_backend(
                    "auto", n=n, k=k, metric=metric, platform=platform) == \
                    j_resolve_build("auto", n=n, k=k, metric=metric,
                                    n_devices=1, platform=j_platform)
    assert topk_build.resolve_build_backend(
        "auto", n=n, k=64, metric="neg_euclidean", platform="cuda") == (
        "twostage" if n >= topk_build.TWOSTAGE_N else "reference")


def test_default_cpu_solve_takes_twostage_with_reference_decisions(
        monkeypatch):
    """A default solve off the card builds with the two-stage merge once
    N >= TWOSTAGE_N. The threshold is lowered to 8,192 here, so the solve
    of 8,197 points (dense_topk, k = 64) stays quick; the routing at the
    real threshold is the table above. Same decisions as the reference
    scan."""
    x, _ = gaussian_blobs(n=8197, k=8, seed=0, spread=0.5)
    calls = []
    real = topk_build.topk_similarity_twostage

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(topk_build, "TWOSTAGE_N", 8192)
    monkeypatch.setattr(topk_build, "topk_similarity_twostage", spy)
    got = solve(x, device="cpu", max_iterations=5, keep_state=True)
    assert got.backend == "dense_topk" and len(calls) == 1
    assert calls[0]["chunk"] == 128 and calls[0]["metric"] == \
        "neg_sqeuclidean"
    ref = solve(x, device="cpu", max_iterations=5, build="reference",
                keep_state=True)
    assert len(calls) == 1
    assert torch.equal(got.state.idx, ref.state.idx)
    assert torch.equal(got.state.hap.s, ref.state.hap.s)
    np.testing.assert_array_equal(got.exemplars, ref.exemplars)
    np.testing.assert_array_equal(got.trace, ref.trace)
