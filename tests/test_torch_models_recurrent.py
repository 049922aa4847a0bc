"""The port's recurrent LM families against the JAX reference, on the CPU
(``-smoke`` configs; tolerances in ``tests/_torch_lm.py``): xlstm (mLSTM
chunkwise form, sLSTM step loop) and recurrentgemma (RG-LRU and local
attention). Also the counterpart of tests/test_xlstm_cell.py: the port's
chunkwise mLSTM against the literal per-step recurrence, a sequence that
is not a multiple of the chunk included, and its state carried across
calls; and the RG-LRU's time loop against the reference's associative
scan."""
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
from repro.models.layers import rglru as ref_rglru  # noqa: E402
from repro.models.layers import xlstm as ref_xlstm  # noqa: E402
from repro_torch.models.layers.rglru import rglru_block_apply  # noqa: E402
from repro_torch.models.layers.xlstm import (  # noqa: E402
    MLSTMState, init_mlstm_state, mlstm_cell,
)

pair = pytest.fixture(scope="module", params=[
    "xlstm-1.3b", "recurrentgemma-9b"])(pair_fixture)


def mlstm_recurrent_oracle(q, k, v, il, fl, state):
    """The literal recurrence in float64:
        m_t = max(logf_t + m_{t-1}, i_t)
        C_t = exp(logf_t + m_{t-1} - m_t) C_{t-1} + exp(i_t - m_t) v k^T
        n_t likewise; h_t = C_t q_t / max(|n_t . q_t|, exp(-m_t))."""
    c, n, m = (np.asarray(x, np.float64) for x in state)
    q, k, v, il, fl = (np.asarray(x, np.float64) for x in (q, k, v, il, fl))
    hs = np.zeros_like(q)
    for t in range(q.shape[2]):
        m_new = np.maximum(fl[..., t] + m, il[..., t])
        f_s = np.exp(fl[..., t] + m - m_new)
        i_s = np.exp(il[..., t] - m_new)
        c = f_s[..., None, None] * c + i_s[..., None, None] * np.einsum(
            "bhd,bhe->bhde", k[..., t, :], v[..., t, :])
        n = f_s[..., None] * n + i_s[..., None] * k[..., t, :]
        m = m_new
        num = np.einsum("bhd,bhde->bhe", q[..., t, :], c)
        den = np.abs(np.einsum("bhd,bhd->bh", q[..., t, :], n))
        hs[..., t, :] = num / np.maximum(den, np.exp(-m) + 1e-6)[..., None]
    return hs, MLSTMState(*(torch.from_numpy(x.astype(np.float32))
                            for x in (c, n, m)))


def _cell_inputs(rng, b, nh, s, dh):
    mk = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    q, k, v = mk(b, nh, s, dh), mk(b, nh, s, dh) / np.float32(dh ** 0.5), \
        mk(b, nh, s, dh)
    il = mk(b, nh, s)
    fl = -np.abs(mk(b, nh, s)) * 0.5            # log sigmoid-ish < 0
    return q, k, v, il, fl


@pytest.mark.parametrize("s,chunk", [(16, 4), (24, 8), (17, 8), (32, 32)])
def test_chunkwise_matches_recurrent_oracle_and_reference(s, chunk):
    b, nh, dh = 2, 3, 8
    arrays = _cell_inputs(np.random.default_rng(s), b, nh, s, dh)
    h, st = mlstm_cell(*(torch.from_numpy(a) for a in arrays),
                       init_mlstm_state(b, nh, dh), chunk)
    h_ref, st_ref = mlstm_recurrent_oracle(*arrays,
                                           init_mlstm_state(b, nh, dh))
    np.testing.assert_allclose(h.numpy(), h_ref, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(st.c.numpy(), st_ref.c.numpy(), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(st.m.numpy(), st_ref.m.numpy(), atol=1e-5,
                               rtol=1e-5)
    h_jax, st_jax = ref_xlstm.mlstm_cell(
        *(jnp.asarray(a) for a in arrays),
        ref_xlstm.init_mlstm_state(b, nh, dh), chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_jax), atol=1e-4,
                               rtol=1e-4)
    for got, want in zip(st, st_jax):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def test_chunkwise_state_carries_across_calls():
    """Two sequential 8-token calls equal one 16-token call."""
    b, nh, s, dh = 1, 2, 16, 8
    q, k, v, il, fl = (torch.from_numpy(a) for a in _cell_inputs(
        np.random.default_rng(1), b, nh, s, dh))
    st0 = init_mlstm_state(b, nh, dh)
    h_all, _ = mlstm_cell(q, k, v, il, fl, st0, chunk=4)
    _, st1 = mlstm_cell(q[:, :, :8], k[:, :, :8], v[:, :, :8], il[..., :8],
                        fl[..., :8], st0, chunk=4)
    h2, _ = mlstm_cell(q[:, :, 8:], k[:, :, 8:], v[:, :, 8:], il[..., 8:],
                       fl[..., 8:], st1, chunk=4)
    np.testing.assert_allclose(h2.numpy(), h_all[:, :, 8:].numpy(),
                               atol=1e-4, rtol=1e-3)


def test_rglru_time_loop_matches_associative_scan():
    """In float32 the loop and the reference's associative scan differ only
    by association: within 1e-5 of the output's scale."""
    from repro_torch.convert import _load
    from repro_torch.models.layers.common import Init
    from repro_torch.models.layers.rglru import RGLRU

    params, _ = ref_rglru.rglru_block_init(jax.random.PRNGKey(3), 32, 48)
    x = np.random.default_rng(3).standard_normal((2, 40, 32)).astype(
        np.float32)
    want, _ = ref_rglru.rglru_block_apply(params, jnp.asarray(x))
    block = RGLRU(Init(None, "cpu"), 32, 48)
    with torch.no_grad():
        _load(block, jax.tree.map(np.asarray, params), "")
        got, _ = rglru_block_apply(block, torch.from_numpy(x))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())
