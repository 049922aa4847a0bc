"""Deterministic, seeded fault injection (port of
``repro/runtime/faultinject.py``, pure Python, the same semantics).

Production code calls ``fire(site, **ctx)`` at named injection points.
With no injector installed that is a dict lookup and a return — cheap
enough to leave in the hot path. Tests and chaos harnesses install a
:class:`FaultInjector` carrying :class:`Rule`\\ s; a matching rule raises
its exception *deterministically*:

* ``nth`` rules fire on an exact per-rule hit counter (the nth matching
  ``fire`` call, 0-based), for ``times`` consecutive hits;
* ``prob`` rules hash ``(seed, site, rule index, hit counter)`` into
  [0, 1) with SHA-256, as the reference does — the *same* hits fail on
  every run with the same seed, in either package;
* ``match`` filters on the context kwargs the site provides
  (``match={"stage": "global"}`` only counts/fires those hits).

The port's sites (grep for ``faultinject.fire``):

=====================  =====================================================
``solver.sweep``       between checkpointed dense_topk sweep segments
``solver.coarsen``     after each coarsen stage/group checkpoint
``serve.launch``       before a worker runs a micro-batch (context:
                       ``worker``, ``bucket``) — a raise is a worker failure
``serve.compile``      before a compile cache builds a handle on a miss
                       (context: ``bucket``), warm-up and resurrection too
=====================  =====================================================

The reference's ``solver.backend`` and ``build.fused`` sites guard its
degrade chains, which the port does not have (a kernel launches or
raises).

The active injector also counts every ``fire`` hit per site (rules or
not) — ``injector.hits(site)`` — which resume tests use to prove work
was *skipped* (a resumed coarsen run re-fires fewer group boundaries).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
from typing import Any, Optional

_ACTIVE: Optional["FaultInjector"] = None


class InjectedFault(RuntimeError):
    """Default exception an injection rule raises."""


@dataclasses.dataclass
class Rule:
    """One injection rule. ``nth`` and ``prob`` are alternatives: an
    exact hit index (fires on hits ``nth .. nth + times - 1``) or a
    deterministic per-hit probability (fires on at most ``times`` hits);
    with neither, the rule fires on the first ``times`` matching hits.
    ``exc`` is the exception *type* to raise."""
    site: str
    nth: Optional[int] = None
    prob: float = 0.0
    times: int = 1
    match: dict = dataclasses.field(default_factory=dict)
    exc: type = InjectedFault


class FaultInjector:
    """Seeded rule set + hit counters. Thread-safe; counters are global
    across threads (deterministic under single-threaded ``drain()``
    pumping; under threaded pumping per-worker ``match`` filters keep a
    rule's counter deterministic per worker)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rules: list[Rule] = []
        self.events: list[dict] = []      # every fired injection
        self._lock = threading.Lock()
        self._rule_hits: dict[int, int] = {}
        self._rule_fired: dict[int, int] = {}
        self._site_hits: dict[str, int] = {}

    def add(self, rule: Rule) -> "FaultInjector":
        self.rules.append(rule)
        return self

    def hits(self, site: str) -> int:
        """Total ``fire(site, ...)`` calls seen (rules or not)."""
        with self._lock:
            return self._site_hits.get(site, 0)

    # ------------------------------------------------------------- firing
    def _unit(self, idx: int, site: str, hit: int) -> float:
        h = hashlib.sha256(
            f"{self.seed}:{site}:{idx}:{hit}".encode()).digest()
        return int.from_bytes(h[:8], "big") / float(1 << 64)

    def _fire(self, site: str, ctx: dict) -> None:
        raise_exc = None
        with self._lock:
            self._site_hits[site] = self._site_hits.get(site, 0) + 1
            for idx, rule in enumerate(self.rules):
                if rule.site != site:
                    continue
                if any(ctx.get(k) != v for k, v in rule.match.items()):
                    continue
                hit = self._rule_hits.get(idx, 0)
                self._rule_hits[idx] = hit + 1
                fired = self._rule_fired.get(idx, 0)
                if fired >= rule.times:
                    continue
                if rule.nth is not None:
                    should = rule.nth <= hit < rule.nth + rule.times
                elif rule.prob > 0.0:
                    should = self._unit(idx, site, hit) < rule.prob
                else:
                    # no trigger spec: fire on the first matching hits
                    should = True
                if should:
                    self._rule_fired[idx] = fired + 1
                    self.events.append(
                        {"site": site, "hit": hit, "rule": idx, **ctx})
                    raise_exc = rule.exc(
                        f"injected fault at {site!r} (hit {hit}, "
                        f"rule {idx}, ctx {ctx})")
                    break
        if raise_exc is not None:
            raise raise_exc


def install(inj: Optional[FaultInjector]) -> None:
    """Install (or, with None, clear) the process-wide injector."""
    global _ACTIVE
    _ACTIVE = inj


def clear() -> None:
    install(None)


def get() -> Optional[FaultInjector]:
    return _ACTIVE


@contextlib.contextmanager
def active(inj: FaultInjector):
    """``with faultinject.active(FaultInjector(seed=7).add(Rule(...)))``"""
    install(inj)
    try:
        yield inj
    finally:
        clear()


def fire(site: str, **ctx: Any) -> None:
    """Injection point: no-op without an active injector; otherwise
    counts the hit and raises if a rule matches."""
    inj = _ACTIVE
    if inj is not None:
        inj._fire(site, ctx)
