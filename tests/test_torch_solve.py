"""``repro_torch.solver.solve(..., device="cpu")`` against ``repro.solver.solve``.

Decisions (exemplars, labels, n_clusters, n_sweeps, converged and the
per-sweep trace) must match exactly. Given the reference's similarity
stack, both packages run the same sweeps from the same S and the whole
trace must match. Given points, each package builds its own S: XLA
contracts multiply-adds (the row norms, the damping) into FMAs and
PyTorch rounds every op, so S differs by an ulp or two. A 3-level run of
this fixture is still oscillating at sweep 50, and such an ulp can move a
single border point in one intermediate sweep (the reference's own
dense_fused and dense_parallel traces differ the same way on this input);
there the final decisions must match exactly and the trace is held by the
similarity-stack test. Float state after a whole solve agrees within
``rtol=1e-4, atol=1e-4 * max|s|``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.preferences import median_preference  # noqa: E402
from repro.core.similarity import (  # noqa: E402
    pairwise_similarity, set_preferences, stack_levels,
)
from repro.data import gaussian_blobs  # noqa: E402
from repro.solver import auto_select as j_auto_select  # noqa: E402
from repro.solver import SolveConfig as JConfig  # noqa: E402
from repro.solver import solve as j_solve  # noqa: E402
from repro_torch.solver import SolveConfig, auto_select, solve  # noqa: E402

BACKENDS = ["dense_sequential", "dense_parallel", "dense_fused"]


@pytest.fixture(scope="module")
def points():
    x, _ = gaussian_blobs(n=96, k=4, seed=6, spread=0.4)
    return x


@pytest.fixture(scope="module")
def stacks(points):
    s = pairwise_similarity(jnp.asarray(points))
    s = set_preferences(s, median_preference(s))
    return {levels: np.asarray(stack_levels(s, levels)) for levels in (1, 3)}


def _assert_same_decisions(got, want, trace=True):
    np.testing.assert_array_equal(got.exemplars, want.exemplars)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.n_clusters, want.n_clusters)
    assert got.n_sweeps == want.n_sweeps
    assert got.converged == want.converged
    assert got.levels == want.levels and got.n == want.n
    if trace:
        np.testing.assert_array_equal(got.trace, want.trace)


@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("stop", ["fixed", "converged"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_on_similarity_stack_matches_reference(backend, stop, levels,
                                                     stacks):
    s3 = stacks[levels]
    want = j_solve(s3, backend=backend, stop=stop, keep_state=True)
    got = solve(s3, backend=backend, stop=stop, keep_state=True,
                device="cpu")
    assert got.backend == backend
    _assert_same_decisions(got, want)
    scale = float(np.abs(s3).max())
    for name, g, w in zip(want.state._fields, got.state, want.state):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("stop", ["fixed", "converged"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_on_points_matches_reference(backend, stop, levels, points):
    want = j_solve(points, backend=backend, stop=stop, levels=levels)
    got = solve(points, backend=backend, stop=stop, levels=levels,
                device="cpu")
    _assert_same_decisions(got, want, trace=levels == 1)


def test_early_stop_trace_and_budget(points):
    got = solve(points, backend="dense_fused", levels=1, stop="converged",
                max_iterations=200, device="cpu")
    assert got.converged and got.n_sweeps < 200
    assert got.trace.shape == (got.n_sweeps,)
    assert np.all(got.trace[-5:] == 0)


@pytest.mark.parametrize("bad", [
    dict(k=0), dict(k=96), dict(patience=-1), dict(max_iterations=0),
    dict(build="nope"), dict(build_block_rows=0), dict(sweep="nope"),
    dict(exchange="nope"), dict(graph_rounds=0),
    dict(graph_target_clusters=0), dict(preseed="nope"),
    dict(checkpoint_every=-1), dict(checkpoint_every=2),
    dict(checkpoint_every=2, checkpoint_dir="ckpt",
         backend="dense_parallel"),
    dict(backend="coarsen", partition_size=1),
    dict(backend="coarsen", preference="random"),
])
def test_validate_config_messages_match_reference(bad, points):
    with pytest.raises(ValueError) as want:
        j_solve(points, **bad)
    with pytest.raises(ValueError) as got:
        solve(points, device="cpu", **bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("data", [np.zeros((2, 3, 4)), np.zeros(5)])
def test_input_shape_errors_match_reference(data):
    with pytest.raises(ValueError) as want:
        j_solve(data)
    with pytest.raises(ValueError) as got:
        solve(data, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,levels,n_devices,has_points,stop", [
    (96, 3, 1, True, "fixed"), (96, 1, 4, False, "fixed"),
    (96, 3, 4, True, "converged"), (9000, 3, 1, True, "fixed"),
    (9000, 1, 1, True, "fixed"), (600_000, 3, 1, True, "fixed"),
    (40, 3, 2, False, "fixed"),
])
def test_auto_select_rules_match_reference(n, levels, n_devices, has_points,
                                           stop):
    for platform, j_platform in (("cuda", "tpu"), ("cpu", "cpu")):
        for has_edges in (False, True):
            got = auto_select(n, levels, n_devices=n_devices,
                              has_points=has_points, platform=platform,
                              cfg=SolveConfig(stop=stop),
                              has_edges=has_edges)
            want = j_auto_select(n, levels, n_devices=n_devices,
                                 has_points=has_points, platform=j_platform,
                                 cfg=JConfig(stop=stop), has_edges=has_edges)
            assert got == want
    assert auto_select(96, 3, n_devices=1, has_points=True, platform="cuda",
                       cfg=SolveConfig()) == "dense_fused"


def test_auto_backend_on_cpu_is_dense_parallel(points):
    got = solve(points, device="cpu", max_iterations=10)
    assert got.backend == "dense_parallel"


def test_solve_without_device_needs_cuda(points, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(points)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(points, device="cuda")


def test_unported_backend_raises_key_error(points):
    with pytest.raises(KeyError, match="registered: dense_fused, "
                                       "dense_parallel, dense_sequential, "
                                       "dense_topk"):
        solve(points, backend="graph_affinity", device="cpu")


def test_graph_preseed_is_not_ported(points):
    with pytest.raises(NotImplementedError, match="not ported"):
        solve(points, preseed="graph", device="cpu")
