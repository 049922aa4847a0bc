"""Serving engine (port of ``repro/serve/engine.py``): prefill and decode
steps and a static-batch driver.

``make_prefill_step`` / ``make_decode_step`` return the step functions;
``ServeEngine`` drives them: prefill once, then decode a token a step,
greedy or by temperature sampling from a ``torch.Generator``. The
reference jits the steps; here they run eagerly under
``torch.inference_mode`` on the parameters' device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import Mode, model_apply, model_state_init, pick_mode


def make_prefill_step(cfg: ArchConfig, seq_len: int):
    mode = pick_mode(cfg, "prefill", seq_len)

    def prefill(params, inputs, states):
        logits, states, _ = model_apply(params, cfg, inputs, mode,
                                        states=states)
        return logits[:, -1], states
    return prefill


def make_decode_step(cfg: ArchConfig):
    mode = Mode(kind="decode", attn_impl="dense")

    def decode(params, inputs, states):
        logits, states, _ = model_apply(params, cfg, inputs, mode,
                                        states=states)
        return logits[:, -1], states
    return decode


def next_tokens(logits: torch.Tensor, temperature: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, V) -> (B,) int32: the argmax (the first of equal maxima), or a
    draw from softmax(logits / temperature)."""
    if temperature > 0.0:
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        nxt = torch.argmax(logits, dim=-1)
    return nxt.to(torch.int32)


class ServeEngine:
    """Static-batch engine on the device of ``params``: prefill once, then
    step-decode."""

    def __init__(self, cfg: ArchConfig, params, *, max_len: int = 4096):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = next(params.parameters()).device
        self._decode = make_decode_step(cfg)

    @torch.inference_mode()
    def generate(
        self, prompt_tokens, *, steps: int = 32, temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
        extras: Optional[dict] = None,
    ) -> torch.Tensor:
        """prompt_tokens (B, S) -> (B, steps) generated ids (int32)."""
        cfg = self.cfg
        dev = self.device
        prompt = torch.as_tensor(prompt_tokens, device=dev)
        b, s = prompt.shape
        total = s + (cfg.img_tokens if cfg.family == "vlm" else 0)
        # list layout: one state a unit (the reference's donated buffers)
        layout = "list" if cfg.family != "audio" else "stacked"
        states = model_state_init(cfg, b, self.max_len, layout=layout,
                                  device=dev)
        inputs = {"tokens": prompt,
                  "positions": torch.arange(total, device=dev)[None].expand(
                      b, total)}
        for name, value in (extras or {}).items():
            inputs[name] = torch.as_tensor(value, device=dev)
        logits, states = make_prefill_step(cfg, total)(self.params, inputs,
                                                       states)
        if temperature > 0.0 and generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        out = []
        for i in range(steps):
            nxt = next_tokens(logits, temperature, generator)[:, None]
            out.append(nxt)
            pos = torch.full((b, 1), total + i, dtype=torch.int32, device=dev)
            logits, states = self._decode(
                self.params, {"tokens": nxt, "positions": pos}, states)
        return torch.cat(out, dim=1)
