"""§3.1 complexity in the port — the counterpart of
``tests/test_complexity.py``: a sweep's work is O(L N^2), and the
MapReduce backends' communication per iteration falls ~1/W a worker in
transpose mode and grows with N in stats mode. The reference's work proxy
sums a jaxpr's output sizes; the port's sums the output elements of the
ops a sweep dispatches (``launch.hlo_cost.CostCounter``, the dry run's
counter) plus its product FLOPs."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.hap import hap_init, hap_sweep_parallel  # noqa: E402
from repro_torch.core.mrhap import comm_bytes_per_iteration  # noqa: E402
from repro_torch.launch.hlo_cost import analyze  # noqa: E402


def _work_proxy(n: int, levels: int = 2) -> float:
    state = hap_init(torch.zeros((levels, n, n)))
    _, cost = analyze(lambda: hap_sweep_parallel(state, 0.5, 0.0, "off",
                                                 False))
    return cost.elementwise + cost.flops


def test_sweep_work_scales_quadratically():
    w64, w128, w256 = _work_proxy(64), _work_proxy(128), _work_proxy(256)
    # doubling N must ~4x the work
    assert 3.0 < w128 / w64 < 5.0
    assert 3.0 < w256 / w128 < 5.0


def test_sweep_work_scales_linearly_in_levels():
    a = _work_proxy(96, levels=2)
    b = _work_proxy(96, levels=4)
    assert 1.7 < b / a < 2.4


def test_comm_scaling_with_workers():
    from repro.core.mrhap import comm_bytes_per_iteration as ref
    n, levels = 4096, 3
    # transpose-mode volume per worker falls ~1/W (the paper's shuffle)
    per_worker_8 = comm_bytes_per_iteration(n, levels, 8, "transpose") / 8
    per_worker_64 = comm_bytes_per_iteration(n, levels, 64,
                                             "transpose") / 64
    assert per_worker_64 < per_worker_8
    # stats mode is N-linear: quadrupling N quadruples bytes
    s1 = comm_bytes_per_iteration(n, levels, 16, "stats")
    s4 = comm_bytes_per_iteration(4 * n, levels, 16, "stats")
    assert 3.5 < s4 / s1 < 4.5
    # transpose mode is N^2: quadrupling N -> ~16x
    t1 = comm_bytes_per_iteration(n, levels, 16, "transpose")
    t4 = comm_bytes_per_iteration(4 * n, levels, 16, "transpose")
    assert t4 / t1 > 10
    for mode in ("stats", "transpose"):
        for w in (8, 16, 64):
            assert comm_bytes_per_iteration(n, levels, w, mode) == ref(
                n, levels, w, mode)
