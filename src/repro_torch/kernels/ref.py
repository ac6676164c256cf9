"""Plain PyTorch oracles of the fused FOLB aggregation
(``repro.kernels.ref``): ``folb_aggregate_ref`` and
``folb_aggregate_stale_ref``."""
from __future__ import annotations

from typing import Tuple

import torch


def folb_aggregate_ref(w: torch.Tensor, deltas: torch.Tensor,
                       grads: torch.Tensor, g1: torch.Tensor,
                       psi_gamma: torch.Tensor, g1_sq: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FOLB single-set aggregation over flattened parameters, all fp32:
      I_k   = <grads_k, g1> − ψγ_k ||g1||²           (Eq. V-B)
      w_new = w + Σ_k I_k Δ_k / max(Σ_k |I_k|, 1e-30)
    w (D,), deltas/grads (K, D), g1 (D,), psi_gamma (K,), g1_sq ()."""
    inner = grads.float() @ g1.float()
    scores = inner - psi_gamma.float() * g1_sq.float()
    denom = torch.clamp(scores.abs().sum(), min=1e-30)
    upd = (scores / denom) @ deltas.float()
    return (w.float() + upd).to(w.dtype), scores


def folb_aggregate_stale_ref(w: torch.Tensor, deltas: torch.Tensor,
                             grads: torch.Tensor, tau: torch.Tensor, alpha,
                             psi_gamma: torch.Tensor, mask: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Staleness-discounted FOLB over flattened parameters, all fp32:
      g1    = Σ_k m_k g_k / max(Σ_k m_k, 1)          (masked mean)
      I_k   = (<g_k, g1> − ψγ_k ||g1||²) · (1 + τ_k)^{−α} · m_k
      w_new = w + Σ_k I_k Δ_k / max(Σ_k |I_k|, 1e-30)"""
    m = mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    g32 = grads.float()
    g1 = (m @ g32) / n
    inner = g32 @ g1
    scores = inner - psi_gamma.float() * (g1 * g1).sum()
    scores = scores * torch.pow(1.0 + tau.float(), -alpha) * m
    denom = torch.clamp(scores.abs().sum(), min=1e-30)
    upd = (scores / denom) @ deltas.float()
    return (w.float() + upd).to(w.dtype), scores
