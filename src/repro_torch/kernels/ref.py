"""Plain PyTorch oracles of the port's kernels (``repro.kernels.ref``):
``folb_aggregate_ref`` and ``folb_aggregate_stale_ref`` for the fused FOLB
aggregation, ``flash_attention_ref`` for attention, ``ssm_scan_ref`` for
the SSD recurrence, and ``slstm_scan_ref`` (one ``slstm_cell`` per step)
for the sLSTM recurrence."""
from __future__ import annotations

from typing import Optional, Tuple

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


NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        sliding_window: int = 0) -> torch.Tensor:
    """Reference attention.  q: (B, Sq, H, d); k/v: (B, Sk, KV, d) with
    H % KV == 0 (GQA: q head h reads kv head h // (H // KV)).  fp32
    softmax over scores masked with -1e30; output in q's dtype."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, d)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                          k.float()) / (d ** 0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window:
        mask &= kpos > qpos - sliding_window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, d).to(q.dtype)


def ssm_scan_ref(x: torch.Tensor, loga: torch.Tensor, w: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential reference of the SSD recurrence (single head group).

    x: (S, H, P); loga/w: (S, H); Bm/Cm: (S, N); h0: (H, P, N).
    h_t = exp(loga_t) h_{t-1} + w_t B_t x_t^T;  y_t = C_t · h_t.
    Returns (y (S, H, P), h_S (H, P, N)), all fp32."""
    S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    x, loga, w = x.float(), loga.float(), w.float()
    Bm, Cm = Bm.float(), Cm.float()
    ys = []
    for t in range(S):
        h = (h * torch.exp(loga[t])[:, None, None]
             + w[t][:, None, None] * torch.einsum("hp,n->hpn", x[t], Bm[t]))
        ys.append(torch.einsum("n,hpn->hp", Cm[t], h))
    return torch.stack(ys), h


def slstm_cell(xg: torch.Tensor, r: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor, n: torch.Tensor):
    """One sLSTM step (``repro.models.xlstm._slstm_cell``).  xg: (B, 4d)
    input part, its 4d axis [z, i, f, o] x (H, dh); r: (H, dh, 4dh);
    h/c/n: (B, d) fp32.  g = xg + h @ r_h in fp32 -> new (h, c, n)."""
    B, d = h.shape
    H, dh = r.shape[0], r.shape[1]
    rec = torch.einsum("bhd,hdk->bhk", h.reshape(B, H, dh), r.float())
    rec = rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4 * d)
    g = xg.float() + rec
    zt, it, ft, ot = torch.chunk(g, 4, dim=-1)
    z, i, f, o = (torch.tanh(zt), torch.sigmoid(it), torch.sigmoid(ft),
                  torch.sigmoid(ot))
    c = f * c + i * z
    n = f * n + i
    return o * c / torch.clamp(n, min=1e-6), c, n


def slstm_scan_ref(xg: torch.Tensor, r: torch.Tensor, n_heads: int):
    """The sLSTM recurrence over the sequence from zero state, one
    ``slstm_cell`` per step.  xg: (B, S, 4d); r: (H, dh, 4dh) with H =
    n_heads.  Returns (out (B, S, d) in xg's dtype, final (h, c, n) fp32)."""
    B, S, d4 = xg.shape
    if r.shape[0] != n_heads:
        raise ValueError(f"r has {r.shape[0]} heads, not {n_heads}")
    h, c, n = (torch.zeros((B, d4 // 4), dtype=torch.float32,
                           device=xg.device) for _ in range(3))
    hs = []
    for t in range(S):
        h, c, n = slstm_cell(xg[:, t], r, h, c, n)
        hs.append(h)
    return torch.stack(hs, dim=1).to(xg.dtype), (h, c, n)
