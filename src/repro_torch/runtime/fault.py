"""Fault tolerance: checkpoint/restart orchestration (port of
``repro/runtime/fault.py``; plain Python, the same semantics).

The policy is the classic MapReduce one the paper inherits from Hadoop
(§1: "distributed, fault-tolerant parallel computing architectures"):

* every K steps the closed training state (parameters, optimizer, step)
  is checkpointed through ``repro_torch.checkpoint`` (async, retained N);
* on failure: reload the latest checkpoint and resume;
* stragglers: a step is bulk-synchronous, so any host can recompute any
  step from the checkpoint and the data cursor (speculative re-execution,
  the MapReduce trick), and the data pipeline prefetches
  (``repro_torch.data.pipeline.Prefetcher``), so transient host hiccups do
  not stall the device step.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

log = logging.getLogger("repro_torch.fault")


@dataclasses.dataclass
class FaultPolicy:
    checkpoint_every: int = 100
    max_restarts: int = 3
    backoff_s: float = 1.0
    allow_elastic_downsize: bool = True


def run_with_restarts(
    run_fn: Callable[[Any], Any],
    restore_fn: Callable[[], Any],
    policy: Optional[FaultPolicy] = None,
) -> Any:
    """Drive ``run_fn(state)`` restarting from ``restore_fn()`` on failure.

    ``run_fn`` must raise to signal an unrecoverable worker error and is
    expected to checkpoint internally every ``policy.checkpoint_every``.
    """
    if policy is None:
        policy = FaultPolicy()
    attempts = 0
    while True:
        try:
            return run_fn(restore_fn())
        except KeyboardInterrupt:
            raise
        except Exception as exc:  # noqa: BLE001 — any worker failure
            attempts += 1
            log.warning("worker failure (%s); restart %d/%d",
                        exc, attempts, policy.max_restarts)
            if attempts > policy.max_restarts:
                raise
            time.sleep(policy.backoff_s * attempts)
