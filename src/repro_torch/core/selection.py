"""Device selection (``repro.core.selection``): a size-K multiset drawn
uniformly with replacement (footnote 1 of the paper), on a
``torch.Generator``.  The reference draws with ``jax.random``; the two are
separate timelines with the same distribution, which is why the port's
engine also accepts a pre-drawn id schedule."""
from __future__ import annotations

import torch


def sample_uniform_ids(generator: torch.Generator, n: int, k: int,
                       rounds: int) -> torch.Tensor:
    """(rounds, k) int64 client ids, uniform over [0, n) with replacement."""
    return torch.randint(0, n, (rounds, k), generator=generator,
                         dtype=torch.int64)
