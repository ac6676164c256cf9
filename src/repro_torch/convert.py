"""Carry the reference's parameters across to the port.

``from_reference`` takes the JAX package's parameter dict of a paper model
as numpy arrays (``jax.tree.map(np.asarray, params)``, done by the caller)
and returns the port's dict of tensors; ``from_reference_model`` does the
same for a transformer-zoo tree, unstacking its layer axes into the lists
``repro_torch.models.model`` walks.  Both packages then start from
identical weights.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve


def from_reference(params_np: Mapping[str, np.ndarray],
                   device=None) -> Dict[str, torch.Tensor]:
    """Reference parameter dict (numpy leaves) -> dict of tensors on
    ``device`` (``None``: the card), same leaf names, copied."""
    dev = resolve(device)
    return {k: _tensor(v, dev) for k, v in params_np.items()}


def _tensor(a, dev: torch.device) -> torch.Tensor:
    """numpy array (fp32, int or ml_dtypes bf16) -> a copy on ``dev``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.tensor(a).to(dev)


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_reference_model(cfg, params_np: Mapping[str, Any],
                         device=None) -> Dict[str, Any]:
    """The reference's ``models.model.init_params`` tree (numpy leaves) ->
    the port's tree on ``device`` (``None``: the card).

    Stacked ``layers`` (L, ...) and ``slstm`` (G, ...) become lists of
    block dicts, stacked ``mamba`` and ``mlstm`` (G, g, ...) lists of G
    lists of g; every other subtree (``embed``, ``lm_head``,
    ``final_norm``, ``shared``) keeps its shape.  Linear weights keep the
    reference's (d_in, d_out) orientation."""
    dev = resolve(device)
    out: Dict[str, Any] = {}
    for key, sub in params_np.items():
        if key in ("layers", "slstm"):
            n = cfg.n_layers if key == "layers" else cfg.n_super_groups()
            out[key] = [_map(sub, lambda a: _tensor(a[i], dev))
                        for i in range(n)]
        elif key in ("mamba", "mlstm"):
            g = (cfg.shared_attn_every if key == "mamba"
                 else cfg.xlstm.slstm_every - 1)
            out[key] = [[_map(sub, lambda a: _tensor(a[i, j], dev))
                         for j in range(g)]
                        for i in range(cfg.n_super_groups())]
        else:
            out[key] = _map(sub, lambda a: _tensor(a, dev))
    return out
