"""Model assembly of the transformer zoo (``repro.models.model``): init,
full-sequence forward, prefill and decode, for two stack topologies:

  * homogeneous -- dense stacks of ``ATTN`` blocks (pre-norm attention +
                   MLP): fed100m, StarCoder2, Gemma, Granite, DeepSeek-Coder.
  * hybrid      -- Zamba2: per super-group ``shared_attn_every`` Mamba2
                   blocks, then ONE shared-parameter attention + MLP block.

Parameters are the reference's tree with its stacked layer axes unstacked
into lists: ``params["layers"][l]`` (homogeneous), ``params["mamba"][g][j]``
and ``params["shared"]`` (hybrid).  Caches mirror that, with lists for the
stacked axes and ``pos`` a Python int.  Prefill and decode write the
KV caches in place.

Not ported yet (raise ``NotImplementedError``, ROADMAP.md queue 1 #16):
the MoE and xLSTM topologies, the encoder/audio and vision frontends, and
the int8 KV cache (``quantize_kv``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ATTN, MAMBA2, SHARED_ATTN, ArchConfig
from repro_torch.models import attention, layers, ssm

Params = Dict[str, Any]


def topology(cfg: ArchConfig) -> str:
    if cfg.family == "hybrid":
        return "hybrid"
    if cfg.xlstm is not None:
        return "xlstm"
    return "homo"


def _check_supported(cfg: ArchConfig) -> None:
    """Raise on what the port does not run yet."""
    missing = None
    if topology(cfg) == "xlstm":
        missing = "the xLSTM topology"
    elif cfg.family == "moe":
        missing = "the MoE topology"
    elif cfg.family in ("encoder", "audio"):
        missing = "the encoder/audio topology"
    elif cfg.frontend_positions:
        missing = "the vision frontend"
    if missing:
        raise NotImplementedError(f"{cfg.name}: {missing} is not ported yet "
                                  f"(ROADMAP.md queue 1 #16)")


# =================================================================== init

def _init_block(cfg: ArchConfig, kind: str, gen) -> Params:
    if kind in (ATTN, SHARED_ATTN):
        p = {"attn_norm": layers.init_norm(cfg, gen, cfg.d_model),
             "attn": attention.init_attention(cfg, gen)}
        if cfg.d_ff:
            p["mlp_norm"] = layers.init_norm(cfg, gen, cfg.d_model)
            p["mlp"] = layers.init_mlp(cfg, gen, cfg.d_model, cfg.d_ff)
        return p
    if kind == MAMBA2:
        return {"norm": layers.init_norm(cfg, gen, cfg.d_model),
                "mamba": ssm.init_mamba2(cfg, gen)}
    raise ValueError(kind)


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random parameters with the reference's distributions, drawn from
    ``gen`` on its device (not JAX's bits)."""
    _check_supported(cfg)
    params: Params = {"final_norm": layers.init_norm(cfg, gen, cfg.d_model),
                      "embed": layers.init_embed(cfg, gen)}
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.init_linear(cfg, gen, cfg.d_model,
                                               cfg.vocab)
    if topology(cfg) == "homo":
        params["layers"] = [_init_block(cfg, ATTN, gen)
                            for _ in range(cfg.n_layers)]
    else:
        params["mamba"] = [[_init_block(cfg, MAMBA2, gen)
                            for _ in range(cfg.shared_attn_every)]
                           for _ in range(cfg.n_super_groups())]
        params["shared"] = _init_block(cfg, SHARED_ATTN, gen)
    return params


# =================================================================== blocks

def _mlp_residual(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if not cfg.d_ff:
        return x
    return x + layers.apply_mlp(cfg, p["mlp"],
                                layers.apply_norm(cfg, p["mlp_norm"], x))


def _apply_block(cfg, kind: str, p: Params, x: torch.Tensor
                 ) -> torch.Tensor:
    """Full-sequence block application."""
    if kind in (ATTN, SHARED_ATTN):
        x = x + attention.attention_forward(
            cfg, p["attn"], layers.apply_norm(cfg, p["attn_norm"], x))
        return _mlp_residual(cfg, p, x)
    if kind == MAMBA2:
        return x + ssm.mamba2_forward(
            cfg, p["mamba"], layers.apply_norm(cfg, p["norm"], x))
    raise ValueError(kind)


# =================================================================== forward

def backbone(cfg: ArchConfig, params: Params, h: torch.Tensor
             ) -> torch.Tensor:
    """Apply the full layer stack. h: (B, S, d) -> (B, S, d)."""
    _check_supported(cfg)
    if topology(cfg) == "homo":
        for lp in params["layers"]:
            h = _apply_block(cfg, ATTN, lp, h)
        return h
    for group in params["mamba"]:
        for lp in group:
            h = _apply_block(cfg, MAMBA2, lp, h)
        h = _apply_block(cfg, SHARED_ATTN, params["shared"], h)
    return h


def embed_inputs(cfg: ArchConfig, params: Params, batch: Dict
                 ) -> torch.Tensor:
    """Token embedding, scaled by sqrt(d_model) for Gemma.  batch keys:
    tokens (B, S) integer."""
    _check_supported(cfg)
    h = layers.embed_tokens(params["embed"], batch["tokens"])
    if cfg.name.startswith("gemma"):
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype,
                             device=h.device)
    return h


def forward(cfg: ArchConfig, params: Params, batch: Dict) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V)."""
    h = backbone(cfg, params, embed_inputs(cfg, params, batch))
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return layers.logits_from_hidden(cfg, params, h)


# =================================================================== serving

def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               quantize_kv: bool = False, device=None) -> Dict:
    """Empty decode cache for a maximum context of ``seq_len`` tokens."""
    _check_supported(cfg)
    C = attention.cache_len_for(cfg, seq_len)
    kv = lambda: attention.init_kv_cache(cfg, batch, C, device=device,
                                         quantize=quantize_kv)
    cache: Dict[str, Any] = {"pos": 0}
    if topology(cfg) == "homo":
        cache["kv"] = [kv() for _ in range(cfg.n_layers)]
    else:
        cache["ssm"] = [[ssm.init_mamba_state(cfg, batch, device=device)
                         for _ in range(cfg.shared_attn_every)]
                        for _ in range(cfg.n_super_groups())]
        cache["kv"] = [kv() for _ in range(cfg.n_super_groups())]
    return cache


def _attn_prefill(cfg, p: Params, h: torch.Tensor, C: int,
                  quantize_kv: bool) -> Tuple[torch.Tensor, Dict]:
    """Attention + MLP block over the prompt -> (h, its new KV cache)."""
    kv0 = attention.init_kv_cache(cfg, h.shape[0], C, device=h.device,
                                  quantize=quantize_kv)
    y, kv = attention.prefill_attention(
        cfg, p["attn"], layers.apply_norm(cfg, p["attn_norm"], h), kv0)
    return _mlp_residual(cfg, p, h + y), kv


def prefill(cfg: ArchConfig, params: Params, batch: Dict,
            cache_len: int = 0, quantize_kv: bool = False
            ) -> Tuple[torch.Tensor, Dict]:
    """Prompt processing: returns last-position logits (B, V) and a cache
    positioned at S, ready for decode_step.  cache_len (>= prompt length)
    reserves headroom for generated tokens; 0 = exactly the prompt."""
    h = embed_inputs(cfg, params, batch)
    S = h.shape[1]
    C = attention.cache_len_for(cfg, max(cache_len, S))
    cache: Dict[str, Any] = {"pos": S, "kv": []}
    if topology(cfg) == "homo":
        for lp in params["layers"]:
            h, kv = _attn_prefill(cfg, lp, h, C, quantize_kv)
            cache["kv"].append(kv)
    else:
        cache["ssm"] = []
        for group in params["mamba"]:
            states = []
            for lp in group:
                y, st = ssm.mamba2_prefill(
                    cfg, lp["mamba"], layers.apply_norm(cfg, lp["norm"], h))
                h = h + y
                states.append(st)
            # the shared block is attention + MLP, as in forward and
            # decode_step; the reference's hybrid prefill leaves the MLP out
            h, kv = _attn_prefill(cfg, params["shared"], h, C,
                                  quantize_kv)
            cache["ssm"].append(states)
            cache["kv"].append(kv)
    h = layers.apply_norm(cfg, params["final_norm"], h[:, -1:])
    return layers.logits_from_hidden(cfg, params, h)[:, 0], cache


def _decode_attn_block(cfg, p: Params, x: torch.Tensor, kv: Dict, pos: int
                       ) -> torch.Tensor:
    y, _ = attention.decode_attention(
        cfg, p["attn"], layers.apply_norm(cfg, p["attn_norm"], x), kv, pos)
    return _mlp_residual(cfg, p, x + y)


def decode_step(cfg: ArchConfig, params: Params, cache: Dict,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens: (B, 1) integer -> logits (B, V) and the
    cache advanced by one position: its KV tensors written in place, the
    Mamba2 states replaced by new tensors."""
    pos = cache["pos"]
    h = embed_inputs(cfg, params, {"tokens": tokens})
    new_cache = dict(cache, pos=pos + 1)
    if topology(cfg) == "homo":
        for lp, kv in zip(params["layers"], cache["kv"]):
            h = _decode_attn_block(cfg, lp, h, kv, pos)
    else:
        new_cache["ssm"] = []
        for group, states, kv in zip(params["mamba"], cache["ssm"],
                                     cache["kv"]):
            new_states = []
            for lp, st in zip(group, states):
                y, st = ssm.mamba2_decode(
                    cfg, lp["mamba"], layers.apply_norm(cfg, lp["norm"], h),
                    st)
                h = h + y
                new_states.append(st)
            h = _decode_attn_block(cfg, params["shared"], h, kv, pos)
            new_cache["ssm"].append(new_states)
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return layers.logits_from_hidden(cfg, params, h)[:, 0], new_cache
