"""Update-validation guard: config and numpy oracle (``repro.kernels.guard``,
a numpy-only copy so the port never imports the reference).

FOLB weights each device by its gradient inner product with the global
gradient, so one corrupted payload can poison the aggregate: a NaN reaches
every reduction, a norm-inflated update dominates the weighted delta sum.
``GuardConfig`` switches on three defences that run inside the flat
aggregation (``kernels.folb_aggregate.folb_aggregate_stale_guarded``):

  nonfinite  -- reject any row whose delta or gradient holds a non-finite
                value (the ``guard_stats`` kernel reports a per-row finite
                flag beside the per-row delta norms).
  clip_mult  -- a row whose delta norm exceeds ``clip_mult x median`` (the
                masked median over the surviving rows) is scaled down to
                the threshold.  0 disables.
  gate_mult  -- a row whose |score| exceeds ``gate_mult x median |score|``
                is excluded.  0 disables.

The medians are recomputed each aggregation from that round's updates, so
the guard carries no state.  A rejected row is excluded like a masked one:
the weights renormalize over the survivors, and an all-rejected
aggregation returns the parameters bit-exact (including -0.0).

``GuardConfig`` is static: frozen and hashable.  ``guard=None`` everywhere
runs the unguarded code path.  ``reference_guard`` is the numpy oracle the
tests hold the guarded aggregation against.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Static robust-aggregation knobs (all defences optional)."""
    nonfinite: bool = True    # reject rows with non-finite delta/grad
    clip_mult: float = 0.0    # clip ||Δ|| above clip_mult × median (0 = off)
    gate_mult: float = 0.0    # drop |score| above gate_mult × median (0 = off)

    def __post_init__(self):
        if self.clip_mult < 0.0:
            raise ValueError(f"clip_mult must be >= 0, got {self.clip_mult}")
        if self.gate_mult < 0.0:
            raise ValueError(f"gate_mult must be >= 0, got {self.gate_mult}")
        if not (self.nonfinite or self.clip_mult > 0.0
                or self.gate_mult > 0.0):
            raise ValueError(
                "GuardConfig with every defense off guards nothing — "
                "pass guard=None instead (the bit-invisible off switch)")


def as_guard(guard: Optional[GuardConfig]) -> Optional[GuardConfig]:
    """Normalize and validate an engine's guard argument."""
    if guard is None:
        return None
    if not isinstance(guard, GuardConfig):
        raise TypeError(
            f"guard must be a repro_torch.kernels.guard.GuardConfig or "
            f"None, got {type(guard).__name__}")
    return guard


def _np_masked_median(x: np.ndarray, m: np.ndarray) -> float:
    """Median of x over entries with m > 0 (the sorted-midpoint convention
    of ``kernels.folb_aggregate.masked_median``); 0.0 on an empty set."""
    K = x.shape[0]
    s = np.sort(np.where(m > 0.0, x, np.inf))
    n = int((m > 0.0).sum())
    if n == 0:
        return 0.0
    lo = min(max((n - 1) // 2, 0), K - 1)
    hi = min(n // 2, K - 1)
    return float(0.5 * (s[lo] + s[hi]))


def reference_guard(deltas: np.ndarray, grads: np.ndarray, tau: np.ndarray,
                    alpha: float, psi_gamma: np.ndarray, mask: np.ndarray,
                    guard: GuardConfig):
    """Numpy replay of the guarded staleness-FOLB weight computation.

    Returns a dict with ``weights`` (per-row delta coefficients, clip
    factors folded in), ``mask`` (the post-guard contribution mask),
    ``scores`` and the three rejection counters.  All math in float32, the
    kernels' accumulator dtype.
    """
    f32 = np.float32
    d = np.asarray(deltas, f32)
    g = np.asarray(grads, f32)
    m_in = np.asarray(mask, f32)
    finite = (np.isfinite(d).all(axis=1)
              & np.isfinite(g).all(axis=1)).astype(f32)
    fin = finite if guard.nonfinite else np.ones_like(finite)
    m0 = m_in * fin
    # non-finite lanes are scrubbed elementwise so no reduction sees them;
    # whole-row rejection is what m0 is for
    g_clean = np.where(np.isfinite(g), g, f32(0.0))
    d_clean = np.where(np.isfinite(d), d, f32(0.0))
    n = f32(max(m0.sum(), 1.0))
    g1 = (m0 @ g_clean) / n
    g1_sq = f32((g1 * g1).sum())
    inner = g_clean @ g1
    scores = inner - np.asarray(psi_gamma, f32) * g1_sq
    scores = scores * np.power(1.0 + np.asarray(tau, f32),
                               -f32(alpha)) * m0
    n_nonfinite = float((m_in * (1.0 - finite)).sum())
    n_gated = 0.0
    if guard.gate_mult > 0.0:
        med = _np_masked_median(np.abs(scores), m0)
        keep = (np.abs(scores) <= guard.gate_mult * med).astype(f32)
        if not med > 0.0:
            keep = np.ones_like(keep)
        n_gated = float((m0 * (1.0 - keep)).sum())
        m0 = m0 * keep
        scores = scores * keep
    clipf = np.ones_like(m0)
    n_clipped = 0.0
    if guard.clip_mult > 0.0:
        norms = np.sqrt((d_clean * d_clean).sum(axis=1))
        thresh = guard.clip_mult * _np_masked_median(norms, m0)
        do_clip = (norms > thresh) & (thresh > 0.0)
        clipf = np.where(do_clip, thresh / np.maximum(norms, 1e-30),
                         f32(1.0))
        n_clipped = float((m0 * do_clip).sum())
    denom = f32(max(np.abs(scores).sum(), 1e-30))
    weights = scores / denom * clipf
    return {"weights": weights, "mask": m0, "scores": scores,
            "n_nonfinite": n_nonfinite, "n_clipped": n_clipped,
            "n_gated": n_gated}
