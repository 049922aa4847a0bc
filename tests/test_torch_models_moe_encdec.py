"""The port's MoE and encoder-decoder families against the JAX reference,
on the CPU (``-smoke`` configs; tolerances in ``tests/_torch_lm.py``):
mixtral, qwen3-moe and whisper. The MoE's routing decisions equal the
reference's on the same inputs at the default capacity factor, dropped
tokens included, and ties go to the lower expert index as
``jax.lax.top_k`` sends them; the one-device path and the specs of
tests/test_moe_sharded.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_lm import (  # noqa: E402,F401  (the shared per-arch tests)
    one_torch_thread, pair_fixture, test_decode_matches_full_forward,
    test_decode_matches_reference, test_forward_matches_reference,
    test_params_round_trip, test_spec_tree_mirrors_reference,
)
from repro.models.layers import moe as ref_moe  # noqa: E402
from repro_torch.convert import _load  # noqa: E402
from repro_torch.models.layers.common import Init, P  # noqa: E402
from repro_torch.models.layers.moe import (  # noqa: E402
    MoE, _route_and_dispatch, capacity, moe_apply, ordered_top_k,
)

pair = pytest.fixture(scope="module", params=[
    "mixtral-8x22b", "qwen3-moe-235b-a22b", "whisper-base"])(pair_fixture)


def _moe_pair(d, d_ff, e, seed=0):
    params, _ = ref_moe.moe_init(jax.random.PRNGKey(seed), d, d_ff, e)
    layer = MoE(Init(None, "cpu"), d, d_ff, e)
    with torch.no_grad():
        _load(layer, jax.tree.map(np.asarray, params), "")
    return params, layer


def _routing(inv, flat_e, e, cap):
    """(expert of each choice, whether it was kept)."""
    inv = np.asarray(inv)
    return np.asarray(flat_e), inv != e * cap


@pytest.mark.parametrize("t,e,k,cf,skew", [
    (64, 4, 2, 1.25, 2.0), (64, 8, 2, 1.25, 3.0), (96, 16, 4, 1.25, 3.0),
    (40, 4, 2, 8.0, 0.0)])
def test_routing_decisions_equal_the_reference(t, e, k, cf, skew):
    """Same input, same router: equal expert choices and kept sets; the
    skewed inputs overfill some experts, so tokens are dropped."""
    d = 32
    params, layer = _moe_pair(d, 48, e, seed=t + e)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((t, d)).astype(np.float32)
    x[:, :4] += skew                       # a shared direction: skewed load
    cap = capacity(t, k, e, cf)
    _, (inv, top_w, probs, flat_e) = ref_moe._route_and_dispatch(
        jnp.asarray(x), params["router"], k, e, 0, e, cap)
    with torch.no_grad():
        _, (tinv, ttop_w, tprobs, tflat_e) = _route_and_dispatch(
            torch.from_numpy(x), layer.router, k, 0, e, cap)
    want_e, want_keep = _routing(inv, flat_e, e, cap)
    got_e, got_keep = _routing(tinv, tflat_e, e, cap)
    np.testing.assert_array_equal(got_e, want_e)
    np.testing.assert_array_equal(got_keep, want_keep)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(inv))
    if cf < 2:
        assert not want_keep.all(), "the case should drop tokens"
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs), atol=1e-6)
    np.testing.assert_allclose(ttop_w.numpy(), np.asarray(top_w), atol=1e-6)


def test_layer_output_equals_the_reference():
    """The one-device layer on the same bfloat16 input, tokens dropped."""
    t, e, k, cf, d = 64, 8, 2, 1.25, 32
    params, layer = _moe_pair(d, 48, e, seed=t + e)
    x = np.random.default_rng(t).standard_normal((t, d)).astype(np.float32)
    x[:, :4] += 3.0
    xb = x.reshape(2, t // 2, d)
    want = ref_moe._moe_dense(params, jnp.asarray(xb).astype(jnp.bfloat16),
                              top_k=k, capacity_factor=cf)
    with torch.no_grad():
        got = moe_apply(layer, torch.from_numpy(xb).bfloat16(), top_k=k,
                        capacity_factor=cf)
    np.testing.assert_allclose(got.y.float().numpy(),
                               np.asarray(want.y.astype(jnp.float32)),
                               atol=3e-2, rtol=2e-2)
    assert abs(float(got.aux_loss) - float(want.aux_loss)) < 1e-5


def test_ties_go_to_the_lower_expert_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    _, idx = ordered_top_k(probs, 3)
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(idx.numpy(), [[1, 2, 3], [0, 1, 2]])


def test_dense_path_without_mesh():
    _, layer = _moe_pair(32, 64, 4)
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = layer(x * 0.5, top_k=2, capacity_factor=8.0)
    assert out.y.shape == x.shape
    assert np.isfinite(float(out.aux_loss))
    assert out.router_probs.shape == (16, 4)


def test_specs_divisibility_aware():
    small = MoE(Init(None, "meta"), 32, 64, 8)     # 8 experts < 16-way axis
    big = MoE(Init(None, "meta"), 32, 64, 128)
    assert small.specs["gate"] == P(None, "data", "model")
    assert big.specs["gate"] == P("model", None, "data")
