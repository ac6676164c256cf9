"""Carry the reference's parameters across to the port.

``from_reference`` takes the JAX package's parameter dict as numpy arrays
(``jax.tree.map(np.asarray, params)``, done by the caller) and returns the
port's dict of tensors, so both packages can start from identical weights.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve


def from_reference(params_np: Mapping[str, np.ndarray],
                   device=None) -> Dict[str, torch.Tensor]:
    """Reference parameter dict (numpy leaves) -> dict of tensors on
    ``device`` (``None``: the card), same leaf names, copied."""
    dev = resolve(device)
    return {k: torch.tensor(np.asarray(v)).to(dev)
            for k, v in params_np.items()}
