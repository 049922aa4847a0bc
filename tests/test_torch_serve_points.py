"""Parity of the port's clustering service with the reference's on the
same requests from points: each package builds its own S (XLA contracts
multiply-adds, ROADMAP C2), so the decisions of every converged solve,
the paths, buckets, generations and counters are equal and the traces
agree within C2's allowance. The harness is ``tests/_torch_serve.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_serve import (  # noqa: E402,F401
    _assert_same_responses, _assert_same_streams, _counters, _drive,
    _parity_services, _parity_traffic,
)


@pytest.mark.parametrize("seed", [2, 3])
def test_service_decisions_match_the_reference_from_points(seed):
    """From points (each package builds its own S): the same paths,
    buckets, generations and counters, equal decisions of every solve
    that converged, and traces within C2's allowance. The N = 500
    overflow rides no stream here: its top-k solve does not converge in
    80 sweeps, so its exemplars follow the drift of S, and a stream would
    install them."""
    ref, port = _parity_services()
    ref.warmup()
    port.warmup()
    first, second = _parity_traffic(seed=seed, overflow_stream=None)
    _assert_same_responses(_drive(ref, first, second),
                           _drive(port, first, second),
                           same_s=False, pref_rel=1e-4)
    _assert_same_streams(ref, port, pref_rel=1e-4, streams=("a",))
    assert _counters(port) == _counters(ref)

