"""Aggregation rules on parameter dicts (``repro.core.aggregation``):
FedAvg (Eq. 2), FOLB single set (Eq. IV-C), heterogeneity-aware FOLB
(Eq. V-B), and their staleness-discounted forms over an arrived-set mask
(``folb_staleness``, ``mean_staleness``), which the sync engine runs at
τ = 0, α = 0 under a scenario's upload mask.  ``deltas``/``grads`` carry
a leading client axis K; all arithmetic is fp32.  The flat-buffer kernel
path for FOLB is ``repro_torch.kernels.ops``; these rules are the
``agg_backend="pytree"`` reference and the fedavg/fedprox rules.
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


def staleness_discounts(tau: torch.Tensor, alpha) -> torch.Tensor:
    """FedBuff-style polynomial discount s(τ) = (1 + τ)^{−α}; α = 0 gives
    exactly 1.0."""
    return torch.pow(1.0 + tau.float(), -alpha)


def _masked_mean_of(stacked: Params, mask: torch.Tensor) -> Params:
    """Mean over the clients with mask == 1 (the arrived set)."""
    m = mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    return {k: torch.tensordot(m, stacked[k].float(), dims=1) / n
            for k in tree.names(stacked)}


def folb_staleness(w_t: Params, deltas: Params, grads: Params,
                   tau: torch.Tensor, alpha: float = 0.0, gammas=None,
                   psi: float = 0.0, mask=None) -> Params:
    """Staleness-discounted heterogeneity-aware FOLB:
    I_k = (<g_k, g1> − ψ γ_k ||g1||²) · (1 + τ_k)^{−α}, normalized over the
    arrived set (``mask``, optional), which alone forms g1.  With τ = 0,
    α = 0, ψ = 0 and no mask this is ``folb_single_set``."""
    g1 = mean_of(grads) if mask is None else _masked_mean_of(grads, mask)
    scores = tree.tree_dot(grads, g1, stacked=True)
    if gammas is not None:
        scores = scores - psi * gammas * tree.tree_sqnorm(g1)
    scores = scores * staleness_discounts(tau, alpha)
    if mask is not None:
        scores = scores * mask.float()
    return _apply(w_t, _weighted_sum(deltas, _normalized(scores)))


def mean_staleness(w_t: Params, deltas: Params, tau: torch.Tensor,
                   alpha: float = 0.0, mask=None) -> Params:
    """Staleness-discounted FedAvg over the arrived clients:
    w + Σ_k s(τ_k) m_k Δ_k / Σ_k s(τ_k) m_k."""
    disc = staleness_discounts(tau, alpha)
    if mask is not None:
        disc = disc * mask.float()
    weights = disc / torch.clamp(disc.sum(), min=1e-30)
    return _apply(w_t, _weighted_sum(deltas, weights))
