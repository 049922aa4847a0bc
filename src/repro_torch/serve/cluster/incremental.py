"""Incremental exemplar assignment: the between-solves fast path (port of
``repro/serve/cluster/incremental.py``).

Xia et al.'s two-stage local/global AP (PAPERS.md) absorbs new data by
assigning it against an existing global exemplar set instead of
re-clustering. Per logical *stream*, the service keeps the last full
solve's exemplar set; incoming points are assigned to their nearest
exemplar with ``repro_torch.core.streaming.assign_nearest_exemplar`` (the
same second pass ``sharded_streaming`` runs) — O(n_new * K) work against
a full solve's O(N^2 * sweeps).

The fast path runs on the host, on CPU tensors, whatever device the
service solves on: the request and the stream's exemplar set are host
arrays, the answer goes back as one, and at the sizes a stream sends (tens
to hundreds of points against tens of exemplars) a round trip to the card
would cost more than the work (``PERF.md`` §5 has both latencies). The
port's pass sums each dot product in a fixed order where the reference's
numpy pass calls a matmul, so a distance can differ in its last bits and
a near-tie can pick the other exemplar.

Drift is the fraction of points *closer to no exemplar than the
preference*: under the negative-squared-Euclidean convention a point with
``max_e s(x, e) < preference`` would rather self-exemplate than join any
existing cluster, i.e. the exemplar set no longer explains it. When the
exponentially-weighted drift fraction crosses the threshold the stream is
stale and the service schedules a background full re-solve over the
stream's accumulated points.

Preference re-calibration: the drift test compares against a preference
derived from the *last solved* window, so a stream whose data scale
shifts would keep judging new data against a stale yardstick for the
whole re-solve flight. ``StreamState.recalibrate`` re-derives the
preference from the current buffered window (a numpy subsample median /
range-mid, the reference's numpy calls, so the value is the reference's
bit for bit); the service invokes it whenever a drift re-solve is
triggered, and the completed re-solve then installs its own
window-derived preference as before. Numeric (calibrated) preferences are
left alone — only string strategies float with the data.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from repro_torch.core.streaming import assign_nearest_exemplar

#: subsample cap for window preference re-derivation — mirrors
#: ``repro_torch.solver.topk.PREF_SAMPLE``'s O(sample^2) constant-in-N cost.
RECAL_SAMPLE = 1024


def window_preference(points: np.ndarray, strategy: str, *,
                      sample: int = RECAL_SAMPLE,
                      seed: int = 0) -> Optional[float]:
    """Median / range-mid of off-diagonal neg-sqeuclidean similarities
    over (a subsample of) ``points`` — pure numpy, the reference's calls,
    so the value equals the reference's bit for bit. Returns None
    for strategies that do not derive from the data (numeric, random,
    constant): those must not float between solves."""
    if not isinstance(strategy, str) or strategy not in (
            "median", "range_mid"):
        return None
    pts = np.asarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[0] < 2:
        return None
    if pts.shape[0] > sample:
        sel = np.random.default_rng(seed).choice(
            pts.shape[0], sample, replace=False)
        pts = pts[sel]
    sq = np.einsum("nd,nd->n", pts, pts)
    s = 2.0 * (pts @ pts.T) - sq[:, None] - sq[None, :]
    off = s[~np.eye(pts.shape[0], dtype=bool)]
    if strategy == "median":
        return float(np.median(off))
    return float(0.5 * (off.min() + off.max()))


@dataclasses.dataclass
class AssignResult:
    """Fast-path output: cluster ids against the stream's exemplar set."""
    labels: np.ndarray           # (n,) index into exemplar_points
    exemplar_points: np.ndarray  # (K, d) the stream's current exemplars
    best_sim: np.ndarray         # (n,) similarity to the chosen exemplar
    drift: float                 # this batch's stale fraction
    stream_drift: float          # stream EWMA after this batch
    resolve_triggered: bool


class StreamState:
    """Everything the service remembers about one logical stream."""

    def __init__(self, stream_id: str, *, drift_threshold: float = 0.25,
                 drift_halflife: int = 256, max_points: int = 100_000):
        self.stream_id = stream_id
        self.drift_threshold = float(drift_threshold)
        # per-point EWMA decay derived from a point-count halflife, so the
        # drift estimate has the same memory whatever the batch sizes
        self.decay = 0.5 ** (1.0 / max(int(drift_halflife), 1))
        self.max_points = int(max_points)
        # RLock: the service may fail a drift re-solve *inside* the
        # enqueue that scheduled it (no healthy worker) — the release of
        # resolve_pending then re-enters this lock on the same thread
        self.lock = threading.RLock()
        self.exemplar_points: Optional[np.ndarray] = None   # (K, d)
        self.preference: float = 0.0
        self.drift_ewma: float = 0.0
        self.points: Optional[np.ndarray] = None            # accumulated
        self.generation = 0          # bumps on every completed full solve
        self.resolve_pending = False

    # ----------------------------------------------------------- updates
    def absorb(self, points: np.ndarray) -> None:
        """Append points to the stream buffer (the re-solve working set),
        bounded by ``max_points`` (oldest dropped first)."""
        points = np.asarray(points, np.float32)
        buf = (points if self.points is None
               else np.concatenate([self.points, points]))
        self.points = buf[-self.max_points:]

    def install(self, exemplar_points: np.ndarray, preference: float
                ) -> None:
        """Adopt a completed full solve's exemplar set; drift resets —
        the new exemplars explain the buffer by construction."""
        self.exemplar_points = np.asarray(exemplar_points, np.float32)
        self.preference = float(preference)
        self.drift_ewma = 0.0
        self.generation += 1
        self.resolve_pending = False

    def recalibrate(self, strategy, window: Optional[int] = None) -> bool:
        """Re-derive the drift-detection preference from the current
        buffered window (the last ``window`` points, or the whole
        buffer). Called by the service when a drift re-solve is
        triggered, so the drift test tracks the data the re-solve will
        actually see while it is in flight. Returns True if the
        preference moved; no-op (False) for non-derived strategies or an
        empty buffer. Caller holds ``self.lock``."""
        if self.points is None:
            return False
        buf = self.points if window is None else self.points[-window:]
        pref = window_preference(buf, strategy, seed=self.generation)
        if pref is None or pref == self.preference:
            return False
        self.preference = pref
        return True

    @property
    def ready(self) -> bool:
        return self.exemplar_points is not None

    def assign(self, points: np.ndarray) -> AssignResult:
        """Nearest-exemplar assignment + drift accounting, on the host.
        Caller holds ``self.lock``."""
        labels, best = assign_nearest_exemplar(
            np.asarray(points, np.float32), self.exemplar_points)
        labels, best = labels.numpy(), best.numpy()
        stale = best < self.preference
        drift = float(stale.mean()) if len(stale) else 0.0
        # fold the batch in point-by-point-equivalent EWMA form
        w = self.decay ** len(points)
        self.drift_ewma = w * self.drift_ewma + (1.0 - w) * drift
        trigger = (self.drift_ewma > self.drift_threshold
                   and not self.resolve_pending)
        if trigger:
            self.resolve_pending = True
        return AssignResult(
            labels=labels, exemplar_points=self.exemplar_points,
            best_sim=best, drift=drift, stream_drift=self.drift_ewma,
            resolve_triggered=trigger)
