"""The 10 assigned architectures (port of ``repro/configs/registry.py``;
exact figures from the assignment table).

``long_500k`` is skipped for pure full-attention archs (quadratic decode
over a 524288-token dense cache) — DESIGN §5; it runs for xlstm-1.3b (O(1)
recurrent state) and recurrentgemma-9b (bounded window + RG-LRU state).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

_FULL_ATTN_SKIP = ("long_500k",)

ARCHS: dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


whisper_base = _reg(ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048, vocab=51865,
    enc_layers=6, enc_seq=1500, norm="ln", mlp="gelu", qkv_bias=True,
    skip_shapes=_FULL_ATTN_SKIP,            # enc-dec, full attention
))

xlstm_1_3b = _reg(ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    pattern=("mlstm",) * 7 + ("slstm",),    # xLSTM[7:1]
    skip_shapes=(),                          # recurrent: all four cells
))

granite_3_8b = _reg(ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_ff=12800, vocab=49155,
    skip_shapes=_FULL_ATTN_SKIP,
))

internlm2_20b = _reg(ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, d_ff=16384, vocab=92544,
    skip_shapes=_FULL_ATTN_SKIP,
))

qwen25_32b = _reg(ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=8, d_ff=27648, vocab=152064,
    qkv_bias=True, tied_embeddings=False,
    skip_shapes=_FULL_ATTN_SKIP,
))

tinyllama_1_1b = _reg(ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv=4, d_ff=5632, vocab=32000,
    skip_shapes=_FULL_ATTN_SKIP,
))

mixtral_8x22b = _reg(ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, d_ff=16384, vocab=32768,
    pattern=("moe",), n_experts=8, top_k=2, window=4096,  # SWA
    tied_embeddings=False,
    skip_shapes=_FULL_ATTN_SKIP,
))

qwen3_moe = _reg(ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, d_ff=1536, vocab=151936,
    pattern=("moe",), n_experts=128, top_k=8, head_dim=128,
    tied_embeddings=False,
    skip_shapes=_FULL_ATTN_SKIP,
))

internvl2_2b = _reg(ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, d_ff=8192, vocab=92553,
    img_tokens=1024,                         # stub InternViT patch prefix
    skip_shapes=_FULL_ATTN_SKIP,
))

recurrentgemma_9b = _reg(ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, d_ff=12288, vocab=256000,
    pattern=("rec", "rec", "attn"), window=2048,  # RG-LRU : local attn, 1:2
    skip_shapes=(),                          # bounded state: all four cells
))


def get_arch(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return ARCHS[name[:-6]].reduced()
    return ARCHS[name]


def arch_names() -> list[str]:
    return list(ARCHS)
