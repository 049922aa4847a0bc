"""Config system (port of ``repro/configs``): architecture and input-shape
configs (the 40 assigned cells).

Every assigned architecture is an ``ArchConfig``; each cell of the dry-run /
roofline matrix is an (ArchConfig, ShapeConfig) pair. ``reduced()`` yields
the CPU-smoke variant of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
BlockKind = Literal["attn", "moe", "rec", "mlstm", "slstm"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    # block layout: repeating pattern; remainder layers appended unrolled
    pattern: tuple[BlockKind, ...] = ("attn",)
    # attention
    head_dim: int = 0               # 0 -> d_model // n_heads
    window: int | None = None       # sliding-window size (SWA / local attn)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid / recurrent
    d_rnn: int = 0                  # 0 -> d_model
    mlstm_chunk: int = 256
    # enc-dec (whisper): encoder layers & fixed frame count (stub frontend)
    enc_layers: int = 0
    enc_seq: int = 0
    # vlm: image-token prefix supplied as precomputed patch embeddings (stub)
    img_tokens: int = 0
    norm: Literal["rms", "ln"] = "rms"
    mlp: Literal["swiglu", "gelu"] = "swiglu"
    tied_embeddings: bool = True
    # which shape cells this arch skips, with reasons (DESIGN §5)
    skip_shapes: tuple[str, ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_d_rnn(self) -> int:
        return self.d_rnn or self.d_model

    def layer_kinds(self) -> list[BlockKind]:
        reps = self.n_layers // len(self.pattern)
        kinds = list(self.pattern) * reps
        kinds += list(self.pattern[: self.n_layers - len(kinds)])
        return kinds

    def reduced(self) -> "ArchConfig":
        """Same family, CPU-smoke sized."""
        pat = len(self.pattern)
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(pat, 2 if pat == 1 else pat),
            d_model=64,
            n_heads=4,
            n_kv=min(self.n_kv, 2),
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_rnn=64 if self.d_rnn or self.family in ("hybrid",) else 0,
            window=min(self.window, 64) if self.window else None,
            mlstm_chunk=16,
            enc_layers=min(self.enc_layers, 2),
            enc_seq=min(self.enc_seq, 32) if self.enc_seq else 0,
            img_tokens=min(self.img_tokens, 8) if self.img_tokens else 0,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[ShapeConfig]:
    return [s for s in SHAPES.values() if s.name not in cfg.skip_shapes]
