"""Failure scenarios: seeded unreliability of the fleet
(``repro.sysmodel.scenario``, the part the synchronous engine uses; a
numpy-only copy so the port never imports the reference).

Independently seeded channels, each drawn from its own numpy stream
``default_rng([seed, CHANNEL_ID])`` so enabling one channel never shifts
another's draws:

  drop         -- the update is computed and sent but the upload fails:
                  it is excluded from aggregation.
  dropout      -- the device goes offline mid-round.  Forbidden in the
                  synchronous engine, whose barrier would wait forever.
  completeness -- the device returns after ``ceil(c * n_steps)`` local
                  steps, ``c ~ U[completeness_min, 1)`` per dispatch with
                  probability ``partial_prob``.
  jitter       -- response time is multiplied by ``exp(sigma * N(0,1))``
                  (only the fleet's wall clock reads it).

Three more channels corrupt the payload (the update arrives, its numbers
are wrong): ``nan`` (every leaf NaN), ``scale`` (norm inflated by
``scale_mag``) and ``flip`` (sign-flipped).  They are realized as one
multiplicative per-dispatch factor (``ScenarioDraws.corrupt``): NaN,
``±scale_mag`` or ``-1``; benign dispatches carry exactly ``1.0``, and
dispatches that never reach aggregation (drop / dropout) are forced back
to ``1.0`` so the masked-row machinery (exact ``0.0 * x``) never multiplies
a NaN.

The channel ids and the draw order are the reference's, so both packages
realize byte-identical arrays from one config.  A config with every rate
at zero is inactive: the engines treat it exactly like ``scenario=None``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# per-channel stream ids (never renumber: seeds are part of the contract)
_CH_DROP = 1
_CH_DROPOUT = 2
_CH_COMPLETE = 3
_CH_JITTER = 4
_CH_NAN = 5
_CH_SCALE = 6
_CH_FLIP = 7


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Seven orthogonal failure channels, all off by default."""
    drop_prob: float = 0.0        # P[upload transmission fails]
    dropout_prob: float = 0.0     # P[device goes offline mid-dispatch]
    partial_prob: float = 0.0     # P[dispatch returns partial work]
    completeness_min: float = 0.5  # c ~ U[completeness_min, 1) when partial
    jitter_sigma: float = 0.0     # latency *= exp(sigma * N(0,1))
    nan_prob: float = 0.0         # P[payload decodes to non-finite]
    scale_prob: float = 0.0       # P[payload norm inflated by scale_mag]
    scale_mag: float = 100.0      # norm-inflation factor when scale fires
    flip_prob: float = 0.0        # P[payload arrives sign-flipped]
    seed: int = 0

    def __post_init__(self):
        for name in ("drop_prob", "dropout_prob", "partial_prob",
                     "nan_prob", "scale_prob", "flip_prob"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if not 0.0 < self.completeness_min <= 1.0:
            raise ValueError("completeness_min must be in (0, 1] — zero "
                             "steps is not a partial result, it is dropout")
        if self.jitter_sigma < 0.0:
            raise ValueError("jitter_sigma must be >= 0")
        if not self.scale_mag > 0.0:
            raise ValueError("scale_mag must be > 0 — a zero factor is a "
                             "drop, not a corruption")

    @property
    def corrupting(self) -> bool:
        """True when any payload-corruption channel can fire."""
        return (self.nan_prob > 0.0 or self.scale_prob > 0.0
                or self.flip_prob > 0.0)

    @property
    def active(self) -> bool:
        return (self.drop_prob > 0.0 or self.dropout_prob > 0.0
                or self.partial_prob > 0.0 or self.jitter_sigma > 0.0
                or self.corrupting)


@dataclasses.dataclass(frozen=True)
class ScenarioDraws:
    """One realization of every channel over a dispatch grid.  ``lost``
    wins over ``drop``; ``lat_scale`` is None when jitter is off and
    ``corrupt`` None when every payload channel is off."""
    drop: np.ndarray                    # bool: upload sent but failed
    lost: np.ndarray                    # bool: device offline, no upload
    comp: np.ndarray                    # float64 in (0, 1]: work fraction
    lat_scale: Optional[np.ndarray]     # float64 > 0, or None
    corrupt: Optional[np.ndarray] = None  # float32 factor (NaN/±mag/−1/1)


def realize(sc: ScenarioConfig, shape: Tuple[int, ...]) -> ScenarioDraws:
    """Sample every channel over ``shape`` dispatches (``(R, K)`` for the
    round-based engine)."""
    seed = int(sc.seed)
    lost = (np.random.default_rng([seed, _CH_DROPOUT]).random(shape)
            < sc.dropout_prob)
    drop = (np.random.default_rng([seed, _CH_DROP]).random(shape)
            < sc.drop_prob) & ~lost
    rng_c = np.random.default_rng([seed, _CH_COMPLETE])
    partial = rng_c.random(shape) < sc.partial_prob
    c_draw = rng_c.uniform(sc.completeness_min, 1.0, shape)
    comp = np.where(partial, c_draw, 1.0)
    lat_scale = None
    if sc.jitter_sigma > 0.0:
        lat_scale = np.exp(sc.jitter_sigma * np.random.default_rng(
            [seed, _CH_JITTER]).standard_normal(shape))
    corrupt = None
    if sc.corrupting:
        nan = (np.random.default_rng([seed, _CH_NAN]).random(shape)
               < sc.nan_prob)
        scl = (np.random.default_rng([seed, _CH_SCALE]).random(shape)
               < sc.scale_prob)
        flp = (np.random.default_rng([seed, _CH_FLIP]).random(shape)
               < sc.flip_prob)
        corrupt = np.where(flp, -1.0, 1.0)
        corrupt = np.where(scl, corrupt * sc.scale_mag, corrupt)
        corrupt = np.where(nan, np.nan, corrupt)
        # a payload that never reaches aggregation must stay benign: the
        # engines cancel masked rows as exact 0·x, which NaN would break
        corrupt = np.where(drop | lost, 1.0, corrupt).astype(np.float32)
    return ScenarioDraws(drop=drop, lost=lost, comp=comp,
                         lat_scale=lat_scale, corrupt=corrupt)


def scale_steps(n_steps: np.ndarray, comp: np.ndarray) -> np.ndarray:
    """``ceil(c * n_steps)``, at least one step, dtype-preserving;
    ``comp == 1.0`` dispatches come back exactly unchanged."""
    base = np.asarray(n_steps)
    return np.maximum(1, np.ceil(comp * base)).astype(base.dtype)


def as_active(sc: Optional[ScenarioConfig]) -> Optional[ScenarioConfig]:
    """A scenario with every channel off becomes None, so the engine takes
    the exact pre-scenario code path."""
    if sc is None or not sc.active:
        return None
    return sc


def check_sync(sc: ScenarioConfig) -> None:
    """The synchronous barrier waits for every selected device, so a
    device that never answers would hang the (simulated) round."""
    if sc.dropout_prob > 0.0:
        raise ValueError(
            "dropout_prob > 0 is not meaningful for the synchronous "
            "engine: the round barrier would wait forever for an offline "
            "device.  Use drop_prob (failed uploads) for sync runs, or "
            "switch to mode='deadline'/'fedbuff' for dropout.")
