"""CPU tests of the plain reference against ``repro_torch`` at small
sizes. The tests import the port; the reference does not."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import _tiny, loadgen, reference
from portbench.programs import solve as solve_program
from portbench.reference import precision
from portbench.reference import similarity as rs


def blobs(n: int, dim: int, seed: int = 9) -> np.ndarray:
    return loadgen.make_pool({"kind": "gaussian_blobs", "n": n,
                              "clusters": 16, "spread": 0.5, "box": 10.0,
                              "dim": dim}, 1, seed)[0]


def test_tf32_rounds_to_nearest_even():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -11, one + 2 ** -10,
                      one + 3 * 2 ** -11, -(one + 3 * 2 ** -11),
                      float("inf"), float("-inf"), 0.0, -8281.0, 3.0e38],
                     dtype=torch.float32)
    want = [one, one, one + 2 ** -10, one + 2 ** -9, -(one + 2 ** -9),
            float("inf"), float("-inf"), 0.0, -8280.0]
    got = precision.tf32(x)
    assert got[:9].tolist() == want
    assert got[9].item() == pytest.approx(3.0e38, rel=2 ** -10)


@pytest.mark.parametrize("dim,n,integer", [(2, 1500, False),
                                           (40, 800, False),
                                           (3, 3000, True)])
def test_topk_lists_equal_the_ports_build(dim, n, integer):
    from repro_torch.solver import SolveConfig
    from repro_torch.solver.topk_build import build_topk_similarity

    x = blobs(n, dim)
    if integer:                      # many exact ties and duplicates
        x = np.round(x * 3)
    xt = torch.from_numpy(x)
    vals, idx = rs.topk_lists(xt, 16)
    pv, pi = build_topk_similarity(xt, 16, SolveConfig(device="cpu"))
    assert torch.equal(idx, pi.to(torch.int32)) and torch.equal(vals, pv)
    # with no spare candidates every row takes the full-row path
    v0, i0 = rs.topk_lists(xt, 16, margin=0)
    assert torch.equal(i0, idx) and torch.equal(v0, vals)


def test_sampled_median_equals_the_ports():
    from repro_torch.solver import topk

    xt = torch.from_numpy(blobs(6000, 2))
    port = topk.sampled_preferences(xt, "median", "neg_sqeuclidean",
                                    topk.sample_generator(0))
    cfg = {"preference": "median", "pref_exact_n": 4096, "k": 16,
           "pref_sample": 2048, "seed": 0, "pref_fold": 0x5EED}
    ref = reference._preference(cfg, None, xt, precision.identity, "topk")
    assert ref.item() == port[0].item()


def test_dense_median_and_similarities_equal_the_ports():
    from repro_torch.core.preferences import median_preference
    from repro_torch.kernels import ops

    # pixels: integer distances, exact in any order of summation
    xt = torch.from_numpy(loadgen.make_pool(
        {"kind": "mandrill_image", "h": 30, "w": 30}, 1, 4)[0])
    s = rs.similarity_matrix(xt)
    assert torch.equal(s, ops.neg_sqeuclidean(xt))
    assert rs.median_offdiag(s).item() == median_preference(s)[0].item()


@pytest.mark.parametrize("name", ["mandrill-dense.median",
                                  "mandrill-dense.random-pref",
                                  "blobs-200k-topk.d2",
                                  "blobs-200k-topk.d128"])
def test_decisions_equal_the_ports_solve(name):
    from repro_torch.solver import solve

    cell = _tiny.tiny_cell(name)
    x = loadgen.make_pool(cell.data, 1, 21)[0]
    res = solve(x, **{**cell.solve, "device": "cpu"})
    ref = reference.decisions(solve_program.reference_config(cell), x,
                              "cpu")
    assert np.array_equal(res.exemplars, ref)
