"""``EdgeList`` — the COO edge-list container behind graph-native input
(port of ``repro/graph/edges.py``; numpy on the host, as there).

An ``EdgeList`` holds directed weighted edges as three parallel arrays
(``src``, ``dst``, ``weight``) plus ``n_nodes``, and converts both ways
against the rest of the port:

* ``from_points`` / ``from_topk`` — the ``topk_build`` pipeline's
  compressed ``(vals, idx)`` layout becomes an edge list (from points on
  the card with the neg-sqeuclidean metric, the fused top-k kernel);
* ``to_topk`` / ``to_dense`` — an edge list becomes the compressed top-k
  layout (``dense_topk`` and ``graph_affinity`` consume it) or a dense
  ``(N, N)`` similarity matrix (the dense backends consume it through
  the engine's densify routing).

Conventions shared with the solver:

* weight = similarity (larger is better), matching the
  negative-squared-Euclidean build convention;
* tie-breaks everywhere are (weight desc, column asc) — the (value desc,
  col asc) order every top-k build implements, so
  ``from_topk(...).to_topk(k)`` round-trips bit-for-bit;
* a missing edge is "strongly repelling": padded/absent slots take
  ``inert_fill(weight)``, a value strictly below every stored weight, and
  padded top-k slots point back at their own row, so they are inert in
  every sweep.

Ingestion, validation and layout conversion are one-shot host work
(numpy, the reference's own calls, so every layout is bit-equal to the
reference's); the iterated hot path lives in ``repro_torch.graph.affinity``
on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def inert_fill(weight: np.ndarray) -> np.float32:
    """A weight strictly below every stored weight — the value a missing
    edge takes when an ``EdgeList`` is laid out densely or padded into
    the top-k layout. Data-scaled (``min - 2*span - 1``) rather than a
    fixed -1e9 so graphs whose weights live at any magnitude keep the
    "never preferred over a real edge" guarantee."""
    if weight.size == 0:
        return np.float32(-1.0)
    lo = float(weight.min())
    span = float(weight.max()) - lo
    return np.float32(lo - 2.0 * span - 1.0)


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Directed weighted COO edges over nodes ``0..n_nodes-1``.

    ``src[e] -> dst[e]`` with similarity ``weight[e]`` means "``dst`` can
    serve as an exemplar for ``src`` at that similarity". Validation at
    construction: equal-length 1-D arrays, finite weights, indices in
    range. Duplicates and self-loops are allowed in the container (they
    are real artifacts of scraped graphs) — ``deduplicated()`` /
    ``without_self_loops()`` / ``symmetrized()`` normalize explicitly,
    and ``canonical()`` is the composition the Borůvka backend requires.
    """
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    n_nodes: int = 0

    def __post_init__(self):
        src = np.asarray(self.src)
        dst = np.asarray(self.dst)
        w = np.asarray(self.weight)
        if not (src.ndim == dst.ndim == w.ndim == 1):
            raise ValueError(
                "EdgeList arrays must be 1-D; got shapes "
                f"src={src.shape}, dst={dst.shape}, weight={w.shape}")
        if not (src.shape == dst.shape == w.shape):
            raise ValueError(
                "EdgeList arrays must have equal length; got "
                f"src={src.shape[0]}, dst={dst.shape[0]}, "
                f"weight={w.shape[0]}")
        for name, a in (("src", src), ("dst", dst)):
            if not np.issubdtype(a.dtype, np.integer):
                raise ValueError(
                    f"EdgeList.{name} must be integer node ids; got "
                    f"dtype {a.dtype}")
        w = w.astype(np.float32)
        if w.size and not np.all(np.isfinite(w)):
            raise ValueError(
                "EdgeList.weight must be finite (no NaN/inf) — a missing "
                "edge is expressed by absence, not by an infinite weight")
        n = int(self.n_nodes)
        if n == 0:
            n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
            n = max(n, 1)
        if n < 1:
            raise ValueError(f"EdgeList.n_nodes must be >= 1; got {n}")
        if src.size and (src.min() < 0 or dst.min() < 0
                         or src.max() >= n or dst.max() >= n):
            raise ValueError(
                f"EdgeList node ids must lie in [0, {n}); got "
                f"src in [{src.min()}, {src.max()}], "
                f"dst in [{dst.min()}, {dst.max()}]")
        object.__setattr__(self, "src", src.astype(np.int32))
        object.__setattr__(self, "dst", dst.astype(np.int32))
        object.__setattr__(self, "weight", w)
        object.__setattr__(self, "n_nodes", n)

    # ------------------------------------------------------------ queries
    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        """Out-degree per node (stored edges, duplicates counted)."""
        return np.bincount(self.src, minlength=self.n_nodes)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max(initial=0))

    @property
    def avg_degree(self) -> float:
        return self.n_edges / max(self.n_nodes, 1)

    # ------------------------------------------------------ normalization
    def without_self_loops(self) -> "EdgeList":
        """Drop ``src == dst`` edges — the diagonal is the preference
        slot in every solver layout, never an edge."""
        keep = self.src != self.dst
        return EdgeList(self.src[keep], self.dst[keep], self.weight[keep],
                        self.n_nodes)

    def deduplicated(self) -> "EdgeList":
        """Collapse duplicate ``(src, dst)`` pairs, keeping the maximum
        weight (the same winner a segment-max selection would pick).
        Output is sorted (src asc, dst asc)."""
        if self.n_edges == 0:
            return self
        # primary src, secondary dst, then weight desc: the first edge of
        # each (src, dst) run is the keeper
        order = np.lexsort((-self.weight, self.dst, self.src))
        s, d, w = self.src[order], self.dst[order], self.weight[order]
        first = np.ones(len(s), bool)
        first[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
        return EdgeList(s[first], d[first], w[first], self.n_nodes)

    def symmetrized(self) -> "EdgeList":
        """Add every reverse edge, then deduplicate (max weight wins
        where both directions exist). Top-k built graphs are asymmetric
        by construction — i's best neighbors rarely reciprocate — and
        the Borůvka contraction's termination argument needs symmetry."""
        return EdgeList(
            np.concatenate([self.src, self.dst]),
            np.concatenate([self.dst, self.src]),
            np.concatenate([self.weight, self.weight]),
            self.n_nodes).deduplicated()

    def canonical(self) -> "EdgeList":
        """What ``graph_affinity`` actually clusters: no self-loops,
        symmetric, duplicate-free."""
        return self.without_self_loops().symmetrized()

    # ------------------------------------------------------- conversions
    @classmethod
    def from_topk(cls, vals, idx, n_nodes: int = 0) -> "EdgeList":
        """Compressed off-diagonal ``(N, k)`` layout -> COO edges, row
        major. The self/preference slot is *not* part of this layout
        (pass ``vals``/``idx`` from ``build_topk_similarity``, not the
        ``kk = k+1`` sweep layout)."""
        vals = np.asarray(vals, np.float32)
        idx = np.asarray(idx)
        if vals.ndim != 2 or vals.shape != idx.shape:
            raise ValueError(
                f"from_topk needs matching (N, k) arrays; got "
                f"vals={vals.shape}, idx={idx.shape}")
        n, k = vals.shape
        src = np.repeat(np.arange(n, dtype=np.int32), k)
        return cls(src, idx.astype(np.int32).ravel(), vals.ravel(),
                   n_nodes or n)

    @classmethod
    def from_points(cls, x, k: int, *, config=None) -> "EdgeList":
        """Points -> edge list through the port's ``topk_build`` pipeline
        (``config.build`` picks reference / two-stage / fused — all
        bit-identical edge sets). ``x`` is built on its own device when it
        is a tensor, else on ``config.device`` (None: "cuda", which must
        be there)."""
        import torch

        from repro_torch.solver.config import SolveConfig
        from repro_torch.solver.engine import resolve_device
        from repro_torch.solver.topk_build import build_topk_similarity

        cfg = config or SolveConfig()
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32)).to(
                resolve_device(cfg.device))
        vals, idx = build_topk_similarity(x.float(), k, cfg)
        return cls.from_topk(vals.cpu().numpy(), idx.cpu().numpy(),
                             x.shape[0])

    def to_topk(self, k: Optional[int] = None, fill=None
                ) -> tuple[np.ndarray, np.ndarray]:
        """Edges -> the compressed ``(N, k)`` off-diagonal layout.

        Per row keep the k best edges by (weight desc, dst asc), emitted
        in column-ascending order — the exact layout every build backend
        produces, so ``from_topk(vals, idx).to_topk(k)`` is a bit-exact
        round trip. ``k=None`` keeps every edge (k = max out-degree).
        Short rows pad with ``(fill, row)`` — an inert self-pointing slot
        per the ``pad_topk`` dummy convention. Duplicates are not merged
        here; call ``deduplicated()`` first for scraped graphs.
        """
        n = self.n_nodes
        if k is None:
            k = max(self.max_degree, 1)
        if k < 1:
            raise ValueError(f"to_topk needs k >= 1; got {k}")
        if fill is None:
            fill = inert_fill(self.weight)
        vals = np.full((n, k), fill, np.float32)
        idx = np.broadcast_to(
            np.arange(n, dtype=np.int32)[:, None], (n, k)).copy()
        if self.n_edges == 0:
            return vals, idx
        # rank edges inside each row by (weight desc, dst asc)...
        order = np.lexsort((self.dst, -self.weight, self.src))
        s = self.src[order]
        starts = np.concatenate(
            [[0], np.cumsum(np.bincount(s, minlength=n))[:-1]])
        keep = (np.arange(len(s)) - starts[s]) < k
        ks, kd, kw = s[keep], self.dst[order][keep], self.weight[order][keep]
        # ...then emit the keepers column-ascending (the build layout)
        order2 = np.lexsort((kd, ks))
        ks, kd, kw = ks[order2], kd[order2], kw[order2]
        starts2 = np.concatenate(
            [[0], np.cumsum(np.bincount(ks, minlength=n))[:-1]])
        pos = np.arange(len(ks)) - starts2[ks]
        vals[ks, pos] = kw
        idx[ks, pos] = kd
        return vals, idx

    def to_dense(self, fill=None) -> np.ndarray:
        """Edges -> dense ``(N, N)`` similarity, missing entries =
        ``fill`` (default ``inert_fill``), duplicates collapsed to their
        max weight, self-loops dropped. The diagonal is left at ``fill``
        — the engine writes preferences there, same contract as the
        points path."""
        if fill is None:
            fill = inert_fill(self.weight)
        s = np.full((self.n_nodes, self.n_nodes), fill, np.float32)
        d = self.without_self_loops().deduplicated()
        s[d.src, d.dst] = d.weight
        return s

    # ------------------------------------------------------- preferences
    def edge_preferences(self, strategy, *, seed: int = 0) -> np.ndarray:
        """Preference vector from the stored weights — the edge-list
        analogue of ``topk_preferences``. ``median`` / ``range_mid``
        reduce over the stored weight multiset (on a symmetrized list
        that multiset is the dense off-diagonal multiset restricted to
        present edges); floats / (N,) arrays broadcast through."""
        n = self.n_nodes
        if strategy is None:
            return np.zeros((n,), np.float32)
        if not isinstance(strategy, str):
            return np.broadcast_to(
                np.asarray(strategy, np.float32), (n,)).copy()
        if strategy == "constant":
            return np.zeros((n,), np.float32)
        if self.n_edges == 0:
            return np.zeros((n,), np.float32)
        if strategy == "median":
            return np.full((n,), np.median(self.weight), np.float32)
        if strategy == "range_mid":
            mid = 0.5 * (float(self.weight.min()) + float(self.weight.max()))
            return np.full((n,), mid, np.float32)
        if strategy == "random":
            # the port's seeded generator (ROADMAP.md C3): other numbers
            # than jax.random's for the same seed
            import torch

            from repro_torch.core.preferences import random_preference
            return random_preference(
                torch.Generator().manual_seed(seed), n).numpy()
        raise ValueError(f"unknown preference strategy: {strategy!r}")
