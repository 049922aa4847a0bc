"""Host-side data pipeline: sharded token streams with prefetch, plus the
HAP-based curation stage (port of ``repro/data/pipeline.py``): the paper's
clustering as a data-pipeline feature, where exemplar selection
deduplicates a batch before it is spent on training compute.

``synthetic_token_stream`` and ``Prefetcher`` are host code, copied with
the reference's numpy calls (the stream is bit-equal). ``hap_curate_batch``
runs flat AP on ``device`` (None means CUDA, and a missing CUDA raises).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.affinity import affinity_propagation
from repro_torch.core.similarity import pairwise_similarity, set_preferences
from repro_torch.solver.engine import as_points


def synthetic_token_stream(
    vocab: int, batch: int, seq: int, seed: int = 0,
) -> Iterator[np.ndarray]:
    """Deterministic synthetic LM data: Zipf-ish unigram + ngram structure
    (enough for loss-goes-down end-to-end runs without external corpora)."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    while True:
        base = rng.choice(vocab, size=(batch, seq), p=probs)
        # inject local structure: token_{t+1} = (token_t * 31 + 7) % vocab
        # on half the positions, so there is something to learn.
        mask = rng.random((batch, seq)) < 0.5
        shifted = (np.roll(base, 1, axis=1) * 31 + 7) % vocab
        out = np.where(mask, shifted, base)
        yield out.astype(np.int32)


class Prefetcher:
    """Background-thread prefetch (depth N) — straggler smoothing at the
    input layer."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = False

        def worker():
            for item in it:
                if self._stop:
                    return
                self.q.put(item)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop = True


def hap_curate_batch(
    embeddings, *, preference: Optional[float] = None,
    iterations: int = 60, damping: float = 0.7,
    device: Optional[str] = None,
) -> np.ndarray:
    """Return indices of exemplar samples for a batch of embeddings.

    Used to deduplicate near-identical samples before training: members of
    a cluster are represented by their exemplar (the paper's "tiered
    aggregation of unstructured data" applied to the data pipeline). A
    tensor runs on its device, numpy input on ``device``.
    """
    s = pairwise_similarity(as_points(embeddings, device))
    if preference is None:
        n = s.shape[0]
        off = s[~torch.eye(n, dtype=torch.bool, device=s.device)]
        preference = float(np.median(off.cpu().numpy()))
    s = set_preferences(s, preference)
    res = affinity_propagation(s, iterations=iterations, damping=damping)
    return np.unique(res.exemplars.cpu().numpy())
