"""Local prox-SGD solvers, batched over clients (``repro.optim.solvers``).

Devices minimize h_k(w, w^t) = F_k(w) + (μ/2)||w − w^t||² (Eq. 3) with a
fixed number of prox-gradient steps; ``gamma_of`` computes the inexactness
γ_k = ||∇h_k(w_k^{t+1}, w^t)|| / ||∇h_k(w^t, w^t)|| (Sec. V-A).

Every parameter dict here carries a leading client axis K.  A gradient
function maps such a dict to the per-client gradients: autograd of
Σ_k F_k, exact per row because the clients do not interact.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import tree
from repro_torch.core.tree import Params


def grad_of(loss_fn: Callable[[Params], torch.Tensor], w: Params) -> Params:
    """Per-client gradients of ``loss_fn`` ((K,) losses) at ``w``."""
    ks = tree.names(w)
    leaves = {k: w[k].detach().requires_grad_(True) for k in ks}
    with torch.enable_grad():
        total = loss_fn(leaves).sum()
        gs = torch.autograd.grad(total, [leaves[k] for k in ks])
    return dict(zip(ks, gs))


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(K,) -> (K, 1, ..., 1) to broadcast against a stacked leaf."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def prox_grad(grad_fn: Callable[[Params], Params], w: Params, w_ref: Params,
              mu: float) -> Params:
    """∇h_k(w, w_ref) = ∇F_k(w) + μ (w − w_ref)."""
    g = grad_fn(w)
    return {k: g[k].float() + mu * (w[k].float() - w_ref[k].float())
            for k in tree.names(w)}


def prox_sgd(grad_fn: Callable[[Params], Params], w_ref: Params, lr: float,
             mu: float, n_steps: torch.Tensor, max_steps: int) -> Params:
    """``max_steps`` prox-gradient steps from ``w_ref``; client k's steps
    ≥ ``n_steps[k]`` are masked as w − lr·live·g with live ∈ {0.0, 1.0},
    exactly as the reference's fixed-length scan (device heterogeneity:
    each device affords only n_steps[k])."""
    w = w_ref
    for i in range(max_steps):
        g = prox_grad(grad_fn, w, w_ref, mu)
        live = (i < n_steps).float()
        w = {k: (w[k].float() - _rows(lr * live, w[k]) * g[k]).to(w[k].dtype)
             for k in tree.names(w)}
    return w


def gamma_of(grad_fn: Callable[[Params], Params], w_new: Params,
             w_ref: Params, mu: float, g_ref: Params) -> torch.Tensor:
    """(K,) γ_k = ||∇h(w_new, w_ref)|| / ||∇F_k(w_ref)||, clipped to [0, 1]
    with the denominator floored at 1e-12.  ``g_ref`` = ∇F_k(w_ref)."""
    gn = tree.tree_norm(prox_grad(grad_fn, w_new, w_ref, mu), stacked=True)
    g0 = tree.tree_norm(g_ref, stacked=True)
    return torch.clamp(gn / torch.clamp(g0, min=1e-12), 0.0, 1.0)


def local_update(loss_fn: Callable[[Params, Dict], torch.Tensor],
                 w_ref: Params, batch: Dict[str, torch.Tensor], lr: float,
                 mu: float, n_steps: torch.Tensor, max_steps: int
                 ) -> Tuple[Params, Params, torch.Tensor]:
    """The K devices' round contributions from the shared global ``w_ref``
    (unstacked) and (K, M, ...) batches -> stacked (Δ_k, ∇F_k(w^t), γ_k)."""
    K = n_steps.shape[0]
    w0 = {k: v.float().unsqueeze(0).expand((K,) + tuple(v.shape)).clone()
          for k, v in w_ref.items()}

    def grad_fn(w):
        return grad_of(lambda p: loss_fn(p, batch), w)

    g_ref = grad_fn(w0)
    w_new = prox_sgd(grad_fn, w0, lr, mu, n_steps, max_steps)
    gamma = gamma_of(grad_fn, w_new, w0, mu, g_ref)
    delta = tree.tree_sub(tree.tree_cast(w_new, torch.float32),
                          tree.tree_cast(w0, torch.float32))
    return delta, g_ref, gamma
