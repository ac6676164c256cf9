"""Aggregation rules on parameter dicts (``repro.core.aggregation``):
FedAvg (Eq. 2), FOLB single set (Eq. IV-C) and heterogeneity-aware FOLB
(Eq. V-B).  ``deltas``/``grads`` carry a leading client axis K; all
arithmetic is fp32.  The flat-buffer kernel path for FOLB is
``repro_torch.kernels.ops.folb_aggregate_tree``; these rules are the
``agg_backend="pytree"`` reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import tree
from repro_torch.core.tree import Params


def _weighted_sum(stacked: Params, weights: torch.Tensor) -> Params:
    """Σ_k weights[k]·stacked[k], leafwise fp32."""
    out = {}
    for k in tree.names(stacked):
        x = stacked[k].float()
        out[k] = (x * weights.reshape((-1,) + (1,) * (x.dim() - 1))).sum(0)
    return out


def _apply(w_t: Params, upd: Params) -> Params:
    return {k: (w_t[k].float() + upd[k]).to(w_t[k].dtype)
            for k in tree.names(w_t)}


def mean_of(stacked: Params) -> Params:
    """(1/K) Σ_k stacked[k] (the global-gradient estimate g1)."""
    return {k: stacked[k].float().mean(0) for k in tree.names(stacked)}


def fedavg_aggregate(w_t: Params, deltas: Params) -> Params:
    """Eq. 2: w^{t+1} = w^t + (1/K) Σ_k Δ_k."""
    K = deltas[tree.names(deltas)[0]].shape[0]
    weights = torch.full((K,), 1.0 / K, dtype=torch.float32,
                         device=deltas[tree.names(deltas)[0]].device)
    return _apply(w_t, _weighted_sum(deltas, weights))


def _normalized(scores: torch.Tensor) -> torch.Tensor:
    return scores / torch.clamp(scores.abs().sum(), min=1e-30)


def folb_single_set(w_t: Params, deltas: Params, grads: Params) -> Params:
    """Eq. IV-C: weights <g_k, g1> / Σ_k' |<g_k', g1>|."""
    g1 = mean_of(grads)
    inner = tree.tree_dot(grads, g1, stacked=True)
    return _apply(w_t, _weighted_sum(deltas, _normalized(inner)))


def folb_het(w_t: Params, deltas: Params, grads: Params,
             gammas: torch.Tensor, psi: float) -> Params:
    """Eq. V-B: I_k = <g1, g_k> − ψ·γ_k·||g1||², weights I_k / Σ|I_k'|."""
    g1 = mean_of(grads)
    inner = tree.tree_dot(grads, g1, stacked=True)
    scores = inner - psi * gammas * tree.tree_sqnorm(g1)
    return _apply(w_t, _weighted_sum(deltas, _normalized(scores)))
