"""Model assembly of the transformer zoo (``repro.models.model``): init,
full-sequence forward, prefill and decode, for three stack topologies:

  * homogeneous -- dense stacks of ``ATTN`` blocks (pre-norm attention +
                   MLP): fed100m, StarCoder2, Gemma, Granite, DeepSeek-Coder.
  * hybrid      -- Zamba2: per super-group ``shared_attn_every`` Mamba2
                   blocks, then ONE shared-parameter attention + MLP block.
  * xlstm       -- xLSTM: per super-group ``slstm_every - 1`` mLSTM blocks,
                   then one sLSTM block.

Parameters are the reference's tree with its stacked layer axes unstacked
into lists: ``params["layers"][l]`` (homogeneous), ``params["mamba"][g][j]``
and ``params["shared"]`` (hybrid), ``params["mlstm"][g][j]`` and
``params["slstm"][g]`` (xlstm).  Caches mirror that, with lists for the
stacked axes and ``pos`` a Python int.  Prefill and decode write the
KV caches in place; decode replaces the recurrent states.

Not ported yet (raise ``NotImplementedError``, ROADMAP.md queue 1 #16):
the MoE topology, the encoder/audio and vision frontends, and the int8 KV
cache (``quantize_kv``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import (ATTN, MAMBA2, MLSTM, SHARED_ATTN,
                                      SLSTM, ArchConfig)
from repro_torch.models import attention, layers, ssm, xlstm

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
    if cfg.family == "moe":
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
    if kind == MLSTM:
        return {"norm": layers.init_norm(cfg, gen, cfg.d_model),
                "mlstm": xlstm.init_mlstm(cfg, gen)}
    if kind == SLSTM:
        return {"norm": layers.init_norm(cfg, gen, cfg.d_model),
                "slstm": xlstm.init_slstm(cfg, gen)}
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
    topo, G = topology(cfg), cfg.n_super_groups()
    if topo == "homo":
        params["layers"] = [_init_block(cfg, ATTN, gen)
                            for _ in range(cfg.n_layers)]
    elif topo == "xlstm":
        params["mlstm"] = [[_init_block(cfg, MLSTM, gen)
                            for _ in range(cfg.xlstm.slstm_every - 1)]
                           for _ in range(G)]
        params["slstm"] = [_init_block(cfg, SLSTM, gen) for _ in range(G)]
    else:
        params["mamba"] = [[_init_block(cfg, MAMBA2, gen)
                            for _ in range(cfg.shared_attn_every)]
                           for _ in range(G)]
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
    if kind == MLSTM:
        return x + xlstm.mlstm_forward(
            cfg, p["mlstm"], layers.apply_norm(cfg, p["norm"], x))
    if kind == SLSTM:
        return x + xlstm.slstm_forward(
            cfg, p["slstm"], layers.apply_norm(cfg, p["norm"], x))
    raise ValueError(kind)


# =================================================================== forward

def backbone(cfg: ArchConfig, params: Params, h: torch.Tensor
             ) -> torch.Tensor:
    """Apply the full layer stack. h: (B, S, d) -> (B, S, d)."""
    _check_supported(cfg)
    topo = topology(cfg)
    if topo == "homo":
        for lp in params["layers"]:
            h = _apply_block(cfg, ATTN, lp, h)
        return h
    if topo == "xlstm":
        for group, sp in zip(params["mlstm"], params["slstm"]):
            for lp in group:
                h = _apply_block(cfg, MLSTM, lp, h)
            h = _apply_block(cfg, SLSTM, sp, h)
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
    topo, G = topology(cfg), cfg.n_super_groups()
    if topo == "homo":
        cache["kv"] = [kv() for _ in range(cfg.n_layers)]
    elif topo == "xlstm":
        cache["mlstm"] = [[xlstm.init_mlstm_state(cfg, batch, device=device)
                           for _ in range(cfg.xlstm.slstm_every - 1)]
                          for _ in range(G)]
        cache["slstm"] = [xlstm.init_slstm_state(cfg, batch, device=device)
                          for _ in range(G)]
    else:
        cache["ssm"] = [[ssm.init_mamba_state(cfg, batch, device=device)
                         for _ in range(cfg.shared_attn_every)]
                        for _ in range(G)]
        cache["kv"] = [kv() for _ in range(G)]
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
    cache: Dict[str, Any] = {"pos": S}
    topo = topology(cfg)
    if topo == "homo":
        cache["kv"] = []
        for lp in params["layers"]:
            h, kv = _attn_prefill(cfg, lp, h, C, quantize_kv)
            cache["kv"].append(kv)
    elif topo == "xlstm":           # no KV cache: quantize_kv is moot
        cache["mlstm"], cache["slstm"] = [], []
        for group, sp in zip(params["mlstm"], params["slstm"]):
            states = []
            for lp in group:
                y, st = xlstm.mlstm_prefill(
                    cfg, lp["mlstm"], layers.apply_norm(cfg, lp["norm"], h))
                h = h + y
                states.append(st)
            y, st = xlstm.slstm_prefill(
                cfg, sp["slstm"], layers.apply_norm(cfg, sp["norm"], h))
            h = h + y
            cache["mlstm"].append(states)
            cache["slstm"].append(st)
    else:
        cache["ssm"], cache["kv"] = [], []
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
    Mamba2, mLSTM and sLSTM states replaced by new tensors."""
    pos = cache["pos"]
    h = embed_inputs(cfg, params, {"tokens": tokens})
    new_cache = dict(cache, pos=pos + 1)
    topo = topology(cfg)
    if topo == "homo":
        for lp, kv in zip(params["layers"], cache["kv"]):
            h = _decode_attn_block(cfg, lp, h, kv, pos)
    elif topo == "xlstm":
        new_cache["mlstm"], new_cache["slstm"] = [], []
        for group, sp, states, sst in zip(params["mlstm"], params["slstm"],
                                          cache["mlstm"], cache["slstm"]):
            new_states = []
            for lp, st in zip(group, states):
                y, st = xlstm.mlstm_decode(
                    cfg, lp["mlstm"], layers.apply_norm(cfg, lp["norm"], h),
                    st)
                h = h + y
                new_states.append(st)
            y, sst = xlstm.slstm_decode(
                cfg, sp["slstm"], layers.apply_norm(cfg, sp["norm"], h), sst)
            h = h + y
            new_cache["mlstm"].append(new_states)
            new_cache["slstm"].append(sst)
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
