"""The paper's experiment models (Sec. VI), batched over clients
(``repro.models.small``): multinomial logistic regression (MCLR), a
3-layer MLP and a character LSTM.

Parameters are dicts of tensors with the reference's leaf names.  The
batched functions take parameters with a leading client axis ``P`` and
inputs with a leading axis ``K``: ``P == K`` gives client k its own
parameters (the port's stand-in for ``jax.vmap`` over clients) and
``P == 1`` shares one set across all K rows (global evaluation).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.paper_models import SmallModelConfig
from repro_torch.core.tree import Params


def init_small(cfg: SmallModelConfig, generator: torch.Generator) -> Params:
    """Initial parameters on the CPU, drawn from ``generator`` (same
    distributions as the reference; not the same numbers, which come from
    ``jax.random``)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32)

    if cfg.kind == "mclr":
        return {"w": zeros(cfg.n_features, cfg.n_classes),
                "b": zeros(cfg.n_classes)}
    if cfg.kind == "mlp":
        s1 = cfg.n_features ** -0.5
        s2 = cfg.hidden ** -0.5
        return {"w1": normal(cfg.n_features, cfg.hidden) * s1,
                "b1": zeros(cfg.hidden),
                "w2": normal(cfg.hidden, cfg.hidden) * s2,
                "b2": zeros(cfg.hidden),
                "w3": normal(cfg.hidden, cfg.n_classes) * s2,
                "b3": zeros(cfg.n_classes)}
    if cfg.kind == "lstm":
        se = cfg.embed ** -0.5
        sh = cfg.hidden ** -0.5
        return {"embed": normal(cfg.vocab, cfg.embed) * 0.1,
                "wx": normal(cfg.embed, 4 * cfg.hidden) * se,
                "wh": normal(cfg.hidden, 4 * cfg.hidden) * sh,
                "b": zeros(4 * cfg.hidden),
                "head_w": zeros(cfg.hidden, cfg.n_classes),
                "head_b": zeros(cfg.n_classes)}
    raise ValueError(cfg.kind)


def _bias(b: torch.Tensor) -> torch.Tensor:
    return b[:, None, :]      # (P, C) -> (P, 1, C), broadcast over rows


def logits_small(cfg: SmallModelConfig, p: Params,
                 x: torch.Tensor) -> torch.Tensor:
    """(K, B, ...) inputs -> (K, B, n_classes) logits."""
    if cfg.kind == "mclr":
        return x @ p["w"] + _bias(p["b"])
    if cfg.kind == "mlp":
        h = torch.relu(x @ p["w1"] + _bias(p["b1"]))
        h = torch.relu(h @ p["w2"] + _bias(p["b2"]))
        return h @ p["w3"] + _bias(p["b3"])
    if cfg.kind == "lstm":
        # x: (K, B, T) int64 tokens; classify from the final hidden state
        embed = p["embed"]
        if embed.shape[0] == 1:
            emb = embed[0][x]                                  # (K,B,T,E)
        else:
            rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
            emb = embed[rows, x]
        K, B = x.shape[0], x.shape[1]
        h = torch.zeros((K, B, cfg.hidden), dtype=emb.dtype, device=x.device)
        c = torch.zeros_like(h)
        for t in range(x.shape[2]):
            g = emb[:, :, t] @ p["wx"] + h @ p["wh"] + _bias(p["b"])
            i, f, o, z = g.chunk(4, dim=-1)    # the reference's gate order
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h @ p["head_w"] + _bias(p["head_b"])
    raise ValueError(cfg.kind)


def small_loss(cfg: SmallModelConfig, p: Params,
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(K,) masked mean cross-entropy over batches {'x', 'y' (int64),
    'mask'} with a leading K axis."""
    logits = logits_small(cfg, p, batch["x"])
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, batch["y"][..., None])[..., 0]
    mask = batch["mask"]
    return -(ll * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)


def small_accuracy(cfg: SmallModelConfig, p: Params,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(K,) masked accuracy."""
    pred = torch.argmax(logits_small(cfg, p, batch["x"]), dim=-1)
    mask = batch["mask"]
    correct = (pred == batch["y"]).float() * mask
    return correct.sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)
