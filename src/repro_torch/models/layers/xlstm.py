"""xLSTM blocks (port of ``repro/models/layers/xlstm.py``; arXiv:2405.04517):
mLSTM (matrix memory, chunkwise-parallel for train and prefill, the same
chunk step for decode) and sLSTM (scalar memory with head-wise recurrent
mixing, a step loop).

mLSTM cell (per head, stabiliser m):
    C_t = f_t C_{t-1} + i_t v_t k_t^T;  n_t = f_t n_{t-1} + i_t k_t
    h_t = (q_t @ C_t) / max(|q_t . n_t|, exp(-m_t))
with i_t = exp(itilde) and f_t = sigmoid(ftilde) in log space. The
chunkwise form takes the intra-chunk terms as a masked quadratic product
and carries (C, n, m) across chunks; the reference's ``lax.scan`` over
chunks and over sLSTM steps are Python loops. A sequence that is not a
multiple of the chunk is padded neutrally (i = -1e30: no write; log f = 0:
no decay), as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import (
    Dense, Init, Module, P, apply_dense,
)


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, NH, Dh, Dh)
    n: torch.Tensor  # (B, NH, Dh)
    m: torch.Tensor  # (B, NH)


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, NH, Dh)
    n: torch.Tensor  # (B, NH, Dh)
    h: torch.Tensor  # (B, NH, Dh)
    m: torch.Tensor  # (B, NH, Dh)


# ------------------------------------------------------------------ mLSTM
class MLSTM(Module):
    def __init__(self, init: Init, d_model: int, n_heads: int):
        super().__init__()
        self.q = Dense(init, d_model, d_model, P(None, "model"))
        self.k = Dense(init, d_model, d_model, P(None, "model"))
        self.v = Dense(init, d_model, d_model, P(None, "model"))
        self.gate = Dense(init, d_model, d_model, P(None, "model"))
        self.out = Dense(init, d_model, d_model, P("model", None))
        self.add("if_proj", init.normal((d_model, 2 * n_heads), 0.01),
                 P(None, None))
        self.add("f_bias", init.full((n_heads,), 3.0), P())


def _mlstm_chunk(carry, xs, scale_eps: float = 1e-6):
    """One chunk. carry: (C, n, m); xs: q, k, v (B, NH, c, Dh), il, fl
    (B, NH, c)."""
    c_prev, n_prev, m_prev = carry
    q, k, v, il, fl = xs
    f_cum = torch.cumsum(fl, dim=-1)                      # F_t
    a = il - f_cum                                        # a_j = i_j - F_j
    big = f_cum[..., :, None] + a[..., None, :]           # F_t + a_j
    ctx = q.shape[-2]
    tri = torch.tril(torch.ones((ctx, ctx), dtype=torch.bool,
                                device=q.device))
    big = big.masked_fill(~tri, -torch.inf)
    intra_max = big.amax(-1)                              # (B, NH, c)
    m_t = torch.maximum(m_prev[..., None] + f_cum, intra_max)
    inter = torch.exp(f_cum + m_prev[..., None] - m_t)
    w = torch.exp(big - m_t[..., None])                   # 0 where masked

    s_qk = torch.einsum("bhtd,bhjd->bhtj", q, k)
    qc = torch.einsum("bhtd,bhde->bhte", q, c_prev)
    numer = inter[..., None] * qc + torch.einsum(
        "bhtj,bhjd->bhtd", w * s_qk, v)
    qn = torch.einsum("bhtd,bhd->bht", q, n_prev)
    denom = inter * qn + (w * s_qk).sum(-1)
    h = numer / torch.maximum(denom.abs(),
                              torch.exp(-m_t) + scale_eps)[..., None]

    # carry to the end of the chunk
    f_all = f_cum[..., -1]                                # F_c
    m_new = torch.maximum(m_prev + f_all, (f_all[..., None] + a).amax(-1))
    decay = torch.exp(f_all + m_prev - m_new)
    wj = torch.exp(f_all[..., None] + a - m_new[..., None])
    c_new = decay[..., None, None] * c_prev + torch.einsum(
        "bhj,bhjd,bhje->bhde", wj, k, v)
    n_new = decay[..., None] * n_prev + torch.einsum("bhj,bhjd->bhd", wj, k)
    return (c_new, n_new, m_new), h


def mlstm_cell(q, k, v, il, fl, state: MLSTMState, chunk: int
               ) -> tuple[torch.Tensor, MLSTMState]:
    """q, k, v: (B, NH, S, Dh) float32; il, fl: (B, NH, S) log gates."""
    s = q.shape[2]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        il = F.pad(il, (0, pad), value=-1e30)
        fl = F.pad(fl, (0, pad))
    carry = (state.c.float(), state.n.float(), state.m.float())
    hs = []
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        carry, h = _mlstm_chunk(carry, (q[:, :, sl], k[:, :, sl],
                                        v[:, :, sl], il[..., sl],
                                        fl[..., sl]))
        hs.append(h)
    return torch.cat(hs, dim=2)[:, :, :s], MLSTMState(*carry)


def mlstm_block_apply(p: MLSTM, x: torch.Tensor,
                      state: Optional[MLSTMState], *, n_heads: int,
                      chunk: int = 256
                      ) -> tuple[torch.Tensor, Optional[MLSTMState]]:
    b, s, d = x.shape
    dh = d // n_heads

    def split(t):
        return t.reshape(b, s, n_heads, dh).transpose(1, 2).float()

    q = split(apply_dense(p.q, x))
    k = split(apply_dense(p.k, x)) / (dh ** 0.5)
    v = split(apply_dense(p.v, x))
    gates = x.float() @ p.if_proj                          # (B, S, 2 NH)
    il = gates[..., :n_heads].transpose(1, 2)              # (B, NH, S)
    fl = F.logsigmoid(gates[..., n_heads:] + p.f_bias).transpose(1, 2)
    keep = state is not None
    if not keep:
        state = init_mlstm_state(b, n_heads, dh, x.device)
    h, new_state = mlstm_cell(q, k, v, il, fl, state, chunk)
    h = h.transpose(1, 2).reshape(b, s, d).to(x.dtype)
    y = apply_dense(p.out, h * F.silu(apply_dense(p.gate, x)))
    return y, (new_state if keep else None)


def init_mlstm_state(batch: int, n_heads: int, dh: int,
                     device=None) -> MLSTMState:
    return MLSTMState(
        c=torch.zeros((batch, n_heads, dh, dh), device=device),
        n=torch.zeros((batch, n_heads, dh), device=device),
        m=torch.full((batch, n_heads), -1e30, device=device))


# ------------------------------------------------------------------ sLSTM
class SLSTM(Module):
    def __init__(self, init: Init, d_model: int, n_heads: int):
        super().__init__()
        dh = d_model // n_heads
        self.add("w_zifo", init.normal((d_model, 4 * d_model),
                                       1.0 / d_model ** 0.5), P(None, "model"))
        self.add("r_zifo", init.normal((4, n_heads, dh, dh), 1.0 / dh ** 0.5),
                 P(None, "model", None, None))
        self.out = Dense(init, d_model, d_model, P("model", None))
        self.add("b_zifo", init.full((4 * d_model,), 0.0), P("model"))


def _slstm_step(p_r, carry: SLSTMState, wx_t):
    """wx_t: (B, 4, NH, Dh), the input's contributions."""
    c, n, h, m = carry
    rec = torch.einsum("ghde,bhe->bghd", p_r, h)          # (B, 4, NH, Dh)
    zt, it, ft, ot = (wx_t[:, i] + rec[:, i] for i in range(4))
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    m_new = torch.maximum(ft + m, it)                      # exp forget gate
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(ft + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    h_new = o * c_new / n_new.abs().clamp_min(1e-6)
    return SLSTMState(c_new, n_new, h_new, m_new), h_new


def slstm_block_apply(p: SLSTM, x: torch.Tensor,
                      state: Optional[SLSTMState], *, n_heads: int
                      ) -> tuple[torch.Tensor, Optional[SLSTMState]]:
    b, s, d = x.shape
    dh = d // n_heads
    wx = (x.float() @ p.w_zifo + p.b_zifo).reshape(b, s, 4, n_heads, dh)
    keep = state is not None
    carry = state if keep else init_slstm_state(b, n_heads, dh, x.device)
    hs = []
    for t in range(s):
        carry, h_t = _slstm_step(p.r_zifo, carry, wx[:, t])
        hs.append(h_t)
    h = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return apply_dense(p.out, h), (carry if keep else None)


def init_slstm_state(batch: int, n_heads: int, dh: int,
                     device=None) -> SLSTMState:
    z = torch.zeros((batch, n_heads, dh), device=device)
    return SLSTMState(c=z, n=z, h=z, m=torch.full_like(z, -1e30))
