"""Attention blocks (``repro.models.attention``): GQA/MQA/MHA, causal and
sliding-window masks, KV-cache prefill and decode.

Full-sequence attention (training forward and prefill) goes through
``kernels.ops.flash_attention``, the hand-written kernel the reference
validated its Pallas flash kernel against this module's ``_attend`` for.
One-token decode attention over the cache is ``_attend``, plain PyTorch,
as it is plain ``jnp`` in the reference.  The reference's mesh-dependent
layouts (``_head_sharding_plan``, ``_attend_auto``) are identities on one
card and are not carried over, nor is its query-chunked ``_attend_chunked``,
whose work the kernel does.

Caches are dicts of tensors that prefill and decode write in place.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers

Params = Dict[str, Any]

NEG_INF = -1e30


def init_attention(cfg, gen) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": layers.init_linear(cfg, gen, d, cfg.n_heads * hd),
        "wk": layers.init_linear(cfg, gen, d, cfg.n_kv_heads * hd),
        "wv": layers.init_linear(cfg, gen, d, cfg.n_kv_heads * hd),
        "wo": layers.init_linear(cfg, gen, cfg.n_heads * hd, d),
    }


def _qkv(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = layers.apply_linear(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = layers.apply_linear(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = layers.apply_linear(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.rope_theta > 0:
        q = layers.apply_rope(cfg, q, positions)
        k = layers.apply_rope(cfg, k, positions)
    return q, k, v


def _attend(cfg, q, k, v, mask) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd), mask: (B,Sq,Sk) or (Sq,Sk) bool
    -> (B, Sq, H*hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                          k.float()) / (hd ** 0.5)
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H * hd).to(q.dtype)


def make_mask(cfg, Sq: int, Sk: int, q_offset: int = 0,
              device=None) -> torch.Tensor:
    """(Sq, Sk) boolean attention mask for self-attention where query i sits
    at absolute position i + q_offset and keys at positions 0..Sk-1."""
    qpos = torch.arange(Sq, device=device) + q_offset
    kpos = torch.arange(Sk, device=device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if cfg.causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if cfg.sliding_window:
        mask &= kpos[None, :] > qpos[:, None] - cfg.sliding_window
    return mask


def _full_attention(cfg, x: torch.Tensor, p: Params):
    """Positions, q/k/v and the kernel's attention over the whole sequence
    -> (out (B, S, H*hd), k, v)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(cfg, p, x, positions)
    out = ops.flash_attention(q, k, v, causal=cfg.causal,
                              sliding_window=cfg.sliding_window)
    return out.reshape(B, S, -1), k, v


def attention_forward(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence self attention (train / prefill compute)."""
    out, _, _ = _full_attention(cfg, x, p)
    return layers.apply_linear(p["wo"], out)


# ------------------------------------------------------------- KV cache

def init_kv_cache(cfg, batch: int, cache_len: int, dtype=None,
                  device=None, quantize: bool = False) -> Dict:
    """Decode KV cache of ``cache_len`` slots, zeros."""
    if quantize:
        raise NotImplementedError(
            "the int8 KV cache (quantize_kv) is not ported yet "
            "(ROADMAP.md queue 1 #16)")
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dtype = dtype or layers.param_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_len_for(cfg, seq_len: int) -> int:
    """Ring-buffer length: full seq, or the window for SWA models."""
    if cfg.sliding_window and cfg.sliding_window < seq_len:
        return cfg.sliding_window
    return seq_len


def prefill_attention(cfg, p: Params, x: torch.Tensor, cache: Dict
                      ) -> Tuple[torch.Tensor, Dict]:
    """Forward over the prompt AND write the last cache_len keys into
    ``cache`` (in place; returned)."""
    S = x.shape[1]
    out, k, v = _full_attention(cfg, x, p)
    C = cache["k"].shape[1]
    for name, val in (("k", k), ("v", v)):
        if C >= S:
            cache[name][:, :S] = val
        else:
            # ring buffer: keep the last C positions; slot i holds position
            # p with p % C == i, so decode-time ring writes stay consistent
            cache[name][:] = torch.roll(val[:, S - C:], S % C, dims=1)
    return layers.apply_linear(p["wo"], out), cache


def decode_attention(cfg, p: Params, x: torch.Tensor, cache: Dict,
                     pos: int) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x: (B,1,d); pos: absolute position of the new
    token; the cache (updated in place) holds positions < pos (a ring for
    SWA)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)
    C = cache["k"].shape[1]
    slot = pos % C
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    # slot j holds absolute position p_j, the largest value <= pos with
    # p_j % C == j; attend iff 0 <= p_j <= pos and within the window
    j = torch.arange(C, device=x.device)
    pj = pos - ((pos - j) % C)
    valid = (pj >= 0) & (pj <= pos)
    if cfg.sliding_window:
        valid &= pj > pos - cfg.sliding_window
    out = _attend(cfg, q, cache["k"], cache["v"], valid[None, None, :])
    return layers.apply_linear(p["wo"], out), cache
