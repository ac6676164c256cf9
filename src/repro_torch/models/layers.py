"""Shared building blocks of the transformer zoo (``repro.models.layers``):
functions over dicts of tensors, with the reference's parameter names.

Linear weights keep the reference's ``(d_in, d_out)`` orientation and are
applied as ``x @ w``.  Norms compute in fp32 and cast back to ``x``'s dtype.
Random init draws the reference's distributions from a ``torch.Generator``
(not JAX's bits).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def randn_scaled(gen: torch.Generator, shape, scale: float,
                 dtype) -> torch.Tensor:
    """N(0, scale²) drawn in fp32 on the generator's device, then cast."""
    return (torch.randn(shape, generator=gen, device=gen.device) * scale
            ).to(dtype)


# ---------------------------------------------------------------- norms

def init_norm(cfg, gen, d: int) -> Params:
    dev, dt = gen.device, param_dtype(cfg)
    p = {"scale": torch.ones((d,), dtype=dt, device=dev)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dt, device=dev)
    return p


def apply_norm(cfg, p: Params, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------- linear

def init_linear(cfg, gen, d_in: int, d_out: int, scale: float = None
                ) -> Params:
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": randn_scaled(gen, (d_in, d_out), scale, param_dtype(cfg))}


def apply_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]


# ---------------------------------------------------------------- MLP / GLU

def init_mlp(cfg, gen, d: int, d_ff: int) -> Params:
    p = {"up": init_linear(cfg, gen, d, d_ff),
         "down": init_linear(cfg, gen, d_ff, d)}
    if cfg.act in ("silu", "geglu"):
        p["gate"] = init_linear(cfg, gen, d, d_ff)
    return p


def apply_mlp(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    up = apply_linear(p["up"], x)
    # jax.nn.gelu defaults to the tanh approximation
    if cfg.act == "silu":
        h = F.silu(apply_linear(p["gate"], x)) * up
    elif cfg.act == "geglu":
        h = F.gelu(apply_linear(p["gate"], x), approximate="tanh") * up
    else:  # gelu
        h = F.gelu(up, approximate="tanh")
    return apply_linear(p["down"], h)


# ---------------------------------------------------------------- RoPE

def rope_freqs(cfg, head_dim: int, device=None) -> torch.Tensor:
    half = head_dim // 2
    return cfg.rope_theta ** (-torch.arange(0, half, dtype=torch.float32,
                                            device=device) / half)


def apply_rope(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(cfg, hd, x.device)                 # (hd/2,)
    ang = positions[..., :, None].float() * freqs         # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                 # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- embeddings

def init_embed(cfg, gen) -> Params:
    return {"w": randn_scaled(gen, (cfg.vocab, cfg.d_model), 0.02,
                              param_dtype(cfg))}


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["w"][tokens]


def logits_from_hidden(cfg, params, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"]["w"].T
    return apply_linear(params["lm_head"], h)
