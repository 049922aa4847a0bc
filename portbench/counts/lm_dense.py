"""FLOPs and bytes of a dense decoder-only transformer's ``generate``
call, from the configuration's sizes (Hugging Face names, as
``reference/lm_dense.py`` reads them) and the call's batch B, prompt
length S and new tokens.

The least any exact implementation needs:

- Matrix weights of a layer: d*H*dh (q) + 2*d*K*dh (k, v) + H*dh*d (o) +
  3*d*ff (SwiGLU); 2 FLOPs a weight for each token a layer processes.
  Biases, norms, RoPE and the softmax are elementwise and not counted.
- Attention, the causal half: a query at position t reads keys 0..t, 2*dh
  FLOPs a key in q.k and as many in p.v, for each of the H heads:
  4*H*dh*(t + 1) a layer.
- The head, 2*d*V for each position whose logits are used: the prompt's
  last, then each decode step's.
- A call is a prefill of the B*S prompt tokens, then new - 1 decode steps
  that feed the new tokens back (the last token is returned, not fed).
- A decode step at position p reads the bfloat16 weights once (every
  non-embedding parameter, the head's V*d, and B rows of the embedding
  when it is not the head), reads the keys and values of the p tokens
  before (2*K*dh bfloat16 a token a layer), and writes the new token's.
"""
from __future__ import annotations

BF16 = 2


def _s(c: dict) -> tuple:
    return (c["hidden_size"], c["num_hidden_layers"],
            c["num_attention_heads"], c["num_key_value_heads"],
            c["head_dim"], c["intermediate_size"], c["vocab_size"])


def layer_weights(c: dict) -> int:
    """Matrix weights of one layer."""
    d, _, h, k, dh, ff, _ = _s(c)
    return 2 * d * h * dh + 2 * d * k * dh + 3 * d * ff


def non_embedding_params(c: dict) -> int:
    """Every parameter but the embedding and the head: the layers' matrix
    weights, biases and norm gains, and the final norm's gain."""
    d, n, h, k, dh, _, _ = _s(c)
    bias = (h + 2 * k) * dh if c["qkv_bias"] else 0
    return n * (layer_weights(c) + bias + 2 * d) + d


def prefill_flops(c: dict, b: int, s: int) -> float:
    d, n, h, _, dh, _, v = _s(c)
    return b * (2.0 * n * layer_weights(c) * s
                + n * 4.0 * h * dh * s * (s + 1) / 2 + 2.0 * d * v)


def decode_flops(c: dict, b: int, s: int, new: int) -> float:
    """The new - 1 decode steps: step j feeds the token at position
    s + j, which reads keys 0..s + j."""
    d, n, h, _, dh, _, v = _s(c)
    steps = new - 1
    keys = steps * (s + 1) + steps * (steps - 1) / 2   # sum of s + j + 1
    return b * (steps * (2.0 * n * layer_weights(c) + 2.0 * d * v)
                + n * 4.0 * h * dh * keys)


def call_flops(c: dict, b: int, s: int, new: int) -> float:
    return prefill_flops(c, b, s) + decode_flops(c, b, s, new)


def decode_bytes(c: dict, b: int, s: int, new: int) -> float:
    """Bytes the new - 1 decode steps read and write, bfloat16."""
    d, n, _, k, dh, _, v = _s(c)
    steps = new - 1
    weights = non_embedding_params(c) + v * d
    if not c["tie_word_embeddings"]:
        weights += b * d                  # the embedding rows looked up
    before = steps * s + steps * (steps - 1) / 2       # sum of s + j
    kv_token = n * 2 * k * dh
    return BF16 * (steps * weights + b * kv_token * (before + steps))
