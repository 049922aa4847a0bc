"""Serving (port of ``repro.serve``): the LM engine (``ServeEngine`` and
its prefill and decode steps), continuous batching, and the exemplar KV
cache. The clustering request engine lives in ``repro_torch.serve.cluster``,
imported by its callers (it pulls in the whole solver stack)."""
from repro_torch.serve.batching import ContinuousBatchingEngine, insert_sequence
from repro_torch.serve.engine import (
    ServeEngine, make_decode_step, make_prefill_step,
)
from repro_torch.serve.kvcache import exemplar_compress_cache

__all__ = ["ContinuousBatchingEngine", "insert_sequence", "ServeEngine",
           "make_prefill_step", "make_decode_step",
           "exemplar_compress_cache"]
