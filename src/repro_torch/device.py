"""Device resolution for the port's entry points.

``device=None`` means the card.  Where no card is present and the caller
did not ask for the CPU, the entry point raises instead of falling back:
a run that silently moved to the CPU would report the wrong device.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
