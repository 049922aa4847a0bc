"""Continuous batching (port of ``repro/serve/batching.py``): a slot-based
scheduler over the decode step.

A fixed batch of B slots decodes in lockstep; a finished sequence frees
its slot at once, and a queued request is prefilled alone and its state
row inserted into the live batch without stalling the other slots. The
per-row cache lengths of ``KVCache`` let rows at different positions
share a batch.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model_state_init
from repro_torch.models.layers.common import tree_map
from repro_torch.serve.engine import make_decode_step, make_prefill_step


def insert_sequence(batch_states: Any, one_states: Any, slot: int) -> Any:
    """A copy of the batch state tree (batch dim B) with row ``slot`` set
    from a single-sequence tree (batch dim 1); any layout, leaves match."""
    def put(full, one):
        full = full.clone()
        full[slot] = one[0]
        return full
    return tree_map(put, batch_states, one_states)


@dataclasses.dataclass
class _Slot:
    request_id: Optional[int] = None
    length: int = 0            # absolute position of the next token
    budget: int = 0            # tokens still to generate
    out: list = dataclasses.field(default_factory=list)


class ContinuousBatchingEngine:
    """Greedy continuous batching over ``slots`` concurrent sequences, on
    the device of ``params``."""

    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None):
        if cfg.family == "audio":
            raise ValueError("continuous batching serves the LM families "
                             "only")
        self.cfg = cfg
        self.params = params
        self.device = next(params.parameters()).device
        self.slots = [_Slot() for _ in range(slots)]
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: deque = deque()
        self.states = model_state_init(cfg, slots, max_len, layout="list",
                                       device=self.device)
        self._decode = make_decode_step(cfg)
        self._next_id = 0
        self.finished: dict[int, np.ndarray] = {}

    # ----------------------------------------------------------- admin
    def submit(self, tokens, max_new: int = 16) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, np.asarray(tokens, np.int32), max_new))
        return rid

    def _admit(self, slot_idx: int) -> None:
        rid, toks, max_new = self.queue.popleft()
        s = len(toks)
        one = model_state_init(self.cfg, 1, self.max_len, layout="list",
                               device=self.device)
        logits, one = make_prefill_step(self.cfg, s)(
            self.params,
            {"tokens": torch.from_numpy(toks)[None].to(self.device),
             "positions": torch.arange(s, device=self.device)[None]},
            one)
        self.states = insert_sequence(self.states, one, slot_idx)
        slot = self.slots[slot_idx]
        slot.request_id = rid
        slot.length = s
        first = int(torch.argmax(logits[0]))
        slot.out = [first]
        slot.budget = max_new - 1
        self._check_finish(slot_idx, first)

    def _check_finish(self, slot_idx: int, token: int) -> None:
        slot = self.slots[slot_idx]
        if slot.budget <= 0 or (self.eos_id is not None
                                and token == self.eos_id):
            self.finished[slot.request_id] = np.asarray(slot.out, np.int32)
            self.slots[slot_idx] = _Slot()

    # ------------------------------------------------------------ step
    def _fill_free_slots(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.request_id is None and self.queue:
                self._admit(i)

    @torch.inference_mode()
    def step(self) -> None:
        """One decode step across all active slots."""
        self._fill_free_slots()
        active = [i for i, s in enumerate(self.slots)
                  if s.request_id is not None]
        if not active:
            return
        b = len(self.slots)
        toks = np.zeros((b, 1), np.int32)
        pos = np.zeros((b, 1), np.int32)
        for i in active:
            slot = self.slots[i]
            toks[i, 0] = slot.out[-1]
            pos[i, 0] = slot.length
            slot.length += 1
        logits, self.states = self._decode(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device),
                          "positions": torch.from_numpy(pos).to(self.device)},
            self.states)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i in active:
            slot = self.slots[i]
            tok = int(nxt[i])
            slot.out.append(tok)
            slot.budget -= 1
            self._check_finish(i, tok)

    def run_to_completion(self, max_steps: int = 10_000) -> dict:
        steps = 0
        while (self.queue or any(s.request_id is not None
                                 for s in self.slots)):
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("continuous batching did not drain")
        return self.finished
