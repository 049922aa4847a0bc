"""Parity of the port's clustering service with the reference's on the
same requests, from the same similarity values (``reference_similarity``
feeds the port the reference's S and top-k values; everything downstream
is the port's): every decision, trace, counter and stream preference
equal, including an overflow to ``dense_topk``. From points (each package
builds its own S): ``test_torch_serve_points.py``. The harness is
``tests/_torch_serve.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_serve import (  # noqa: E402,F401
    _assert_same_responses, _assert_same_streams, _blobs, _counters, _drive,
    _parity_services, _parity_traffic, reference_similarity,
)


def test_service_parity_from_the_same_similarities(reference_similarity):
    """From the reference's S, the port's service answers the mixed
    traffic exactly as the reference's does: labels, exemplars, sweeps,
    flags, traces, paths, buckets, stream generations, every counter and
    the stream preferences."""
    ref, port = _parity_services()
    assert ref.warmup()["misses"] == port.warmup()["misses"] == 6
    first, second = _parity_traffic(seed=1)
    ref_out, port_out = (_drive(ref, first, second),
                         _drive(port, first, second))
    _assert_same_responses(ref_out, port_out, same_s=True, pref_rel=1e-6)
    _assert_same_streams(ref, port, pref_rel=1e-6)
    assert _counters(port) == _counters(ref)
    counters = _counters(port)
    assert counters["overflow_solves"] == 2
    assert counters["resolves_triggered"] == 1
    assert counters["deadline_rejects"] == 1
    assert counters["fast_assigns"] == 3



def test_overflow_parity_with_the_reference(reference_similarity):
    """N = 500 past a lowered max_bucket_n: the exact-preference branch
    (N <= PREF_EXACT_N) of both packages; from the same top-k values the
    dense_topk decisions, trace and the stream's installed preference
    are the reference's."""
    ref, port = _parity_services(max_bucket_n=64)
    x = _blobs(500, seed=11)[0]
    want = ref.solve_sync(x, stream="o")
    got = port.solve_sync(x, stream="o")
    assert got.solve.backend == want.solve.backend == "dense_topk"
    _assert_same_responses([want], [got], same_s=True, pref_rel=1e-6)
    assert port.stream_info("o") == ref.stream_info("o")
    assert _counters(port) == _counters(ref)

