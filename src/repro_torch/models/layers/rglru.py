"""RG-LRU recurrent block (port of ``repro/models/layers/rglru.py``;
RecurrentGemma / Griffin, arXiv:2402.19427).

Recurrence (per channel):
    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs the linear recurrence as ``lax.associative_scan`` in
sequence mode and as ``lax.scan`` when a state is carried. Here both are
one float32 loop over time, h_t = a_t * h_{t-1} + b_t: the same
recurrence in the step order, which the associative scan regroups, so the
sequence mode agrees with the reference to float32 rounding (a few ulps
of h), far below the bfloat16 rounding of the block's output.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import (
    Dense, Init, Module, P, apply_dense, gelu,
)

_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor     # (B, d_rnn) recurrent state
    conv: torch.Tensor  # (B, 3, d_rnn) last 3 conv inputs


class RGLRU(Module):
    def __init__(self, init: Init, d_model: int, d_rnn: int):
        super().__init__()
        self.proj_x = Dense(init, d_model, d_rnn, P(None, "model"))
        self.proj_gate = Dense(init, d_model, d_rnn, P(None, "model"))
        self.proj_out = Dense(init, d_rnn, d_model, P("model", None))
        self.w_r = Dense(init, d_rnn, d_rnn, P(None, "model"))
        self.w_i = Dense(init, d_rnn, d_rnn, P(None, "model"))
        self.add("conv_w", init.normal((4, d_rnn), 0.5), P(None, "model"))
        # softplus^-1 of a ~ 0.95^8
        self.add("lam", init.full((d_rnn,), 0.65), P("model"))

    def forward(self, x, state=None):
        return rglru_block_apply(self, x, state)


def _causal_conv4(x: torch.Tensor, w: torch.Tensor,
                  prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv, width 4. x: (B, S, C); prev: (B, 3, C)."""
    if prev is None:
        prev = x.new_zeros((x.shape[0], 3, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)
    wd = w.to(x.dtype)
    s = x.shape[1]
    out = 0
    for i in range(4):
        out = out + xp[:, i:i + s] * wd[i]
    return out


def _gates(p: RGLRU, u: torch.Tensor):
    r = torch.sigmoid(apply_dense(p.w_r, u).float())
    i = torch.sigmoid(apply_dense(p.w_i, u).float())
    a = torch.exp(-_C * F.softplus(p.lam.float()) * r)
    b = torch.sqrt((1.0 - a * a).clamp_min(1e-12)) * i * u.float()
    return a, b


def rglru_block_apply(p: RGLRU, x: torch.Tensor,
                      state: Optional[RGLRUState] = None
                      ) -> tuple[torch.Tensor, Optional[RGLRUState]]:
    """x: (B, S, D). No state: sequence mode from h_0 = 0, and no state
    is returned; with a state (prefill or decode) it is carried through."""
    u_pre = apply_dense(p.proj_x, x)                         # (B, S, d_rnn)
    gate = gelu(apply_dense(p.proj_gate, x))
    u = _causal_conv4(u_pre, p.conv_w,
                      state.conv if state is not None else None)
    a, b = _gates(p, u)                                      # float32
    h_t = (state.h.float() if state is not None
           else a.new_zeros((a.shape[0], a.shape[2])))
    hs = []
    for t in range(a.shape[1]):
        h_t = a[:, t] * h_t + b[:, t]
        hs.append(h_t)
    h = torch.stack(hs, dim=1)
    new_state = None
    if state is not None:
        # the conv state carries the last 3 pre-conv inputs
        conv_tail = torch.cat([state.conv, u_pre], dim=1)[:, -3:]
        new_state = RGLRUState(h_t.to(state.h.dtype), conv_tail)
    y = apply_dense(p.proj_out, h.to(x.dtype) * gate)
    return y, new_state


def init_rglru_state(batch: int, d_rnn: int, dtype,
                     device=None) -> RGLRUState:
    return RGLRUState(
        h=torch.zeros((batch, d_rnn), dtype=dtype, device=device),
        conv=torch.zeros((batch, 3, d_rnn), dtype=dtype, device=device))


def rglru_state_specs(data_axes=("pod", "data")) -> RGLRUState:
    d = tuple(data_axes)
    return RGLRUState(h=P(d, "model"), conv=P(d, None, "model"))
