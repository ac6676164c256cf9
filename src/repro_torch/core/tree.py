"""Dict-of-tensor linear algebra used by the FL core (``repro.core.tree``).

Parameters are flat dicts ``{leaf name: tensor}``.  Leaves are visited in
sorted-key order, which is ``jax.tree_util``'s order for dicts, so sums
over leaves add in the reference's order.  All reductions are fp32.

``stacked=True`` reduces each row of a leading client axis separately
(the port's stand-in for ``jax.vmap`` over clients) and returns ``(K,)``.
"""
from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def names(tree: Params):
    """Leaf names in ``jax.tree_util`` order (sorted dict keys)."""
    return sorted(tree)


def tree_dot(a: Params, b: Params, stacked: bool = False) -> torch.Tensor:
    """<a, b> over all leaves, fp32 accumulate, leaves added in order."""
    total = None
    for name in names(a):
        prod = a[name].float() * b[name].float()
        s = prod.flatten(1).sum(1) if stacked else prod.sum()
        total = s if total is None else total + s
    return total


def tree_sqnorm(a: Params, stacked: bool = False) -> torch.Tensor:
    return tree_dot(a, a, stacked)


def tree_norm(a: Params, stacked: bool = False) -> torch.Tensor:
    return torch.sqrt(tree_sqnorm(a, stacked))


def tree_sub(a: Params, b: Params) -> Params:
    return {k: a[k] - b[k] for k in names(a)}


def tree_cast(a: Params, dtype) -> Params:
    return {k: a[k].to(dtype) for k in names(a)}
