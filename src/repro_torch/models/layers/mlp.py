"""Feed-forward blocks (port of ``repro/models/layers/mlp.py``): SwiGLU
(llama family) and GELU (whisper / ViT)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import (
    Dense, Init, Module, P, apply_dense, gelu,
)


class SwiGLU(Module):
    def __init__(self, init: Init, d_model: int, d_ff: int):
        super().__init__()
        self.gate = Dense(init, d_model, d_ff, P(None, "model"))
        self.up = Dense(init, d_model, d_ff, P(None, "model"))
        self.down = Dense(init, d_ff, d_model, P("model", None))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu_apply(self, x)


def swiglu_apply(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return apply_dense(p.down, F.silu(apply_dense(p.gate, x))
                       * apply_dense(p.up, x))


class GeluMLP(Module):
    def __init__(self, init: Init, d_model: int, d_ff: int):
        super().__init__()
        self.up = Dense(init, d_model, d_ff, P(None, "model"), P("model"))
        self.down = Dense(init, d_ff, d_model, P("model", None), P())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu_mlp_apply(self, x)


def gelu_mlp_apply(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    return apply_dense(p.down, gelu(apply_dense(p.up, x)))


def mlp_class(cfg) -> type:
    return SwiGLU if cfg.mlp == "swiglu" else GeluMLP
