"""Plain PyTorch oracle of the fused FOLB aggregation
(``repro.kernels.ref.folb_aggregate_ref``)."""
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
