"""``dense_topk`` backend internals: compressed-layout build and driver
(port of ``repro/solver/topk.py``).

Similarities live as a top-k-per-row ``(N, kk)`` pair (values and column
indices, kk = k + 1 with slot 0 the self/preference slot) instead of the
dense ``(N, N)`` matrix: O(L * N * k) message state instead of
O(L * N^2). The sweep is the dense family's §3 Jacobi schedule
(``core.hap.jacobi_sweep``) with the ``kernels.topk_ops`` updates and
reducers injected, driven by the same ``dense.drive_sweeps`` loop.

A dropped edge is a -inf similarity, under which the sparse updates equal
the dense ones restricted to stored positions: at ``k = N - 1``
``run_topk`` reproduces ``dense_parallel``'s decisions.

Known difference from the reference: the preference subsample of
``sampled_preferences`` is drawn with ``torch.randperm`` on a CPU
``torch.Generator`` seeded from ``SolveConfig.seed`` and the reference's
fold constant 0x5eed; ``jax.random.permutation`` cannot be reproduced, so
above ``PREF_EXACT_N`` points the preference differs from the reference's
(it is the same on the CPU and on the card).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import hap
from repro_torch.core.preferences import make_preferences, random_preference
from repro_torch.core.similarity import pairwise_similarity
from repro_torch.kernels.topk_ops import (
    alpha_topk, assignments_topk, c_topk, incoming_edges, phi_topk, rho_topk,
    s_next_topk, tau_topk,
)
from repro_torch.kernels.topk_similarity import topk_from_dense
from repro_torch.solver import dense
from repro_torch.solver.config import SolveConfig
from repro_torch.solver.topk_build import build_topk_similarity

#: default neighbors per row (excluding self) when ``SolveConfig.k`` is None
DEFAULT_K = 64


class TopKState(NamedTuple):
    """Final message state of a ``dense_topk`` run (``keep_state``):
    ``hap`` carries (L, N, kk) s/r/a and (L, N) tau/phi/c; ``idx`` maps
    stored positions back to global columns."""
    hap: hap.HAPState
    idx: torch.Tensor


def resolve_k(k: Optional[int], n: int) -> int:
    """cfg.k -> effective neighbor count: the default when None, clamped to
    the lossless maximum N - 1."""
    if k is None:
        return min(DEFAULT_K, n - 1)
    if k < 1:
        raise ValueError(f"k must be >= 1; got {k}")
    return min(k, n - 1)


#: above this N, string preference strategies switch from the stored top-k
#: values (biased toward near neighbors once k << N) to a dense subsample
PREF_EXACT_N = 4096
PREF_SAMPLE = 2048
#: the reference's fold constant for the subsample's random draw
PREF_FOLD = 0x5eed


def sample_generator(seed: int) -> torch.Generator:
    """The CPU generator the preference subsample is drawn from, seeded from
    ``seed`` and ``PREF_FOLD`` (decoupled from any other use of ``seed``)."""
    state = np.random.SeedSequence([seed % 2 ** 64, PREF_FOLD])
    return torch.Generator().manual_seed(int(state.generate_state(1)[0]))


def sampled_preferences(x: torch.Tensor, strategy: str, metric: str,
                        generator: torch.Generator) -> torch.Tensor:
    """Estimate the dense preference (median / range-mid of *all*
    off-diagonal similarities) from a ``PREF_SAMPLE``-point subsample,
    drawn on the CPU ``generator`` so the draw is the same on every
    device."""
    n = x.shape[0]
    sel = torch.randperm(n, generator=generator)[:PREF_SAMPLE]
    s = pairwise_similarity(x[sel.to(x.device)], metric=metric)
    return make_preferences(s, strategy)[0].expand(n).clone()


def topk_preferences(vals: torch.Tensor, strategy, *,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Preference strategies over the stored off-diagonal values. At
    k = N - 1 the stored multiset is the whole off-diagonal set, so
    ``median``/``range_mid`` equal the dense preferences; the median is
    the mean of the two middle order statistics."""
    n, k = vals.shape
    if strategy is None:
        # dense-path convention: an untouched diagonal is 0 (max pref)
        return torch.zeros(n, dtype=vals.dtype, device=vals.device)
    if not isinstance(strategy, str):
        return torch.as_tensor(strategy, dtype=vals.dtype,
                               device=vals.device).expand(n).clone()
    if strategy == "median":
        flat, cnt = vals.reshape(-1), n * k
        lo = torch.kthvalue(flat, (cnt - 1) // 2 + 1).values
        hi = torch.kthvalue(flat, cnt // 2 + 1).values
        return (0.5 * (lo + hi)).expand(n).clone()
    if strategy == "range_mid":
        return (0.5 * (vals.amin() + vals.amax())).expand(n).clone()
    if strategy == "random":
        if generator is None:
            raise ValueError("random preferences need a torch.Generator")
        return random_preference(generator, n, dtype=vals.dtype,
                                 device=vals.device)
    if strategy == "constant":
        return torch.zeros(n, dtype=vals.dtype, device=vals.device)
    raise ValueError(f"unknown preference strategy: {strategy}")


def _with_self_slot(vals: torch.Tensor, idx: torch.Tensor,
                    pref: torch.Tensor):
    n = vals.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=idx.device)
    return (torch.cat([pref[:, None].float(), vals], dim=1),
            torch.cat([rows[:, None], idx.to(torch.int32)], dim=1))


def build_from_points(x: torch.Tensor, k: int, levels: int, *,
                      metric: str = "neg_sqeuclidean", preference="median",
                      seed: int = 0, config: Optional[SolveConfig] = None):
    """Points -> ((L, N, kk) value stack, (N, kk) index map) without ever
    materializing the N x N matrix; ``config.build`` picks the build."""
    x = x.float()
    n = x.shape[0]
    cfg = (config or SolveConfig()).replace(metric=metric)
    vals, idx = build_topk_similarity(x, k, cfg)
    if (isinstance(preference, str)
            and preference in ("median", "range_mid")
            and n > PREF_EXACT_N and k < n - 1):
        pref = sampled_preferences(x, preference, metric,
                                   sample_generator(seed))
    else:
        pref = topk_preferences(vals, preference,
                                generator=torch.Generator().manual_seed(seed))
    s_rows, idx_full = _with_self_slot(vals, idx, pref)
    return s_rows.expand(levels, *s_rows.shape).contiguous(), idx_full


def compress_stack(s3: torch.Tensor, k: int):
    """(L, N, N) dense stack -> compressed stack sharing one sparsity
    pattern, selected on level 0. The diagonal (caller-owned preferences)
    lands in the self slot untouched."""
    levels, n, _ = s3.shape
    _, idx = topk_from_dense(s3[0], k)
    rows = torch.arange(n, dtype=torch.int32, device=s3.device)
    idx_full = torch.cat([rows[:, None], idx], dim=1)
    s3k = torch.take_along_dim(
        s3.float(), idx_full.long().expand(levels, -1, -1), dim=2)
    return s3k, idx_full


def make_topk_sweep(idx: torch.Tensor, *, damping: float, kappa: float,
                    s_mode: str):
    """The ``(sweep, assign)`` pair for the compressed layout. The
    incoming-edge order of ``idx`` is built here, once per solve."""
    edges = incoming_edges(idx)
    reducers = hap.SweepReducers(
        tau=lambda r, c: tau_topk(r, c, edges), phi=phi_topk, c=c_topk,
        s_next=s_next_topk)

    def update_r(s, a, tau, r):
        return hap._damp(r, rho_topk(s, a, tau), damping)

    def update_a(r, c, phi, a):
        return hap._damp(a, alpha_topk(r, c, phi, idx, edges), damping)

    def sweep(state, it):
        return hap.jacobi_sweep(
            state, it == 0, lam=damping, kappa=kappa, s_mode=s_mode,
            update_r=update_r, update_a=update_a, reducers=reducers)

    def assign(state):
        return assignments_topk(state.a, state.r, idx)

    return sweep, assign


def run_topk(s3k: torch.Tensor, idx: torch.Tensor, *, max_iterations: int,
             damping: float = 0.5, kappa: float = 0.0, s_mode: str = "off",
             stop: str = "fixed", patience: int = 5):
    """Run the sparse Jacobi schedule on a compressed (L, N, kk) stack.

    Same return contract as ``dense.run_dense``:
    ``(state, exemplars, n_sweeps, converged, trace)``, with the state a
    ``TopKState``.
    """
    s3k = s3k.float().contiguous()
    levels, n, _ = s3k.shape
    sweep, assign = make_topk_sweep(idx, damping=damping, kappa=kappa,
                                    s_mode=s_mode)
    state, e, n_sweeps, conv, trace = dense.drive_sweeps(
        hap.hap_init(s3k), sweep, assign, levels, n,
        max_iterations=max_iterations, stop=stop, patience=patience)
    return TopKState(state, idx), e, n_sweeps, conv, trace
