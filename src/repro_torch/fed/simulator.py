"""Synchronous federated rounds, batched over clients
(``repro.fed.simulator``).

Ported so far: the cohort algorithms fedavg, fedprox, folb (the paper's
main method, Eq. IV-C) and folb_het (Eq. V-B), on the flat kernel backend
and the dict ("pytree") backend, under a failure scenario's upload mask
and payload corruption, and with the update guard (``FLConfig.guard``,
folb/folb_het on the flat backend).  A round takes its device ids as a
tensor, like the reference's ``fl_round_cohort``: the engine draws them
before the run (or replays a given schedule).

Device computational heterogeneity follows the paper's protocol: each
selected device draws a uniform number of local steps in [1, max_local]
from a round-indexed numpy seed shared with the reference, so both
packages see identical device capabilities.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.core.tree import Params
from repro_torch.kernels import ops
from repro_torch.kernels.guard import as_guard
from repro_torch.models import small
from repro_torch.optim import solvers
from repro_torch.sysmodel import scenario as scenario_mod

ALGOS = ("fedavg", "fedprox", "fednu_direct", "fednu_signed", "fednu_norm",
         "folb", "folb2", "folb_het")
PORTED_ALGOS = ("fedavg", "fedprox", "folb", "folb_het")
AGG_BACKENDS = ("flat", "pytree")
AGG_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """The reference's sync config; the fields the port does not run yet
    raise ``NotImplementedError`` when set.  ``guard`` is validated as in
    the reference: a ``kernels.guard.GuardConfig``, folb/folb_het only,
    flat backend only."""
    algo: str = "folb"
    n_selected: int = 10        # K
    mu: float = 1.0             # prox weight (0 for fedavg)
    lr: float = 0.05
    max_local_steps: int = 20
    het_steps: bool = True      # random 1..max per device (paper protocol)
    psi: float = 0.0            # heterogeneity penalty weight (folb_het)
    agg_backend: str = "flat"   # "flat": fused kernels; "pytree": dict rules
    agg_dtype: str = "bfloat16"  # storage dtype of the (K, D) buffers
    server_opt: str = "sgd"
    server_lr: float = 1.0
    telemetry: bool = False
    guard: Optional[Any] = None
    sampler: str = "categorical"
    seed: int = 0

    def __post_init__(self):
        if self.algo not in ALGOS:
            raise ValueError(f"unknown algo {self.algo!r}")
        if self.agg_backend not in AGG_BACKENDS:
            raise ValueError(f"unknown agg_backend {self.agg_backend!r}")
        if self.agg_dtype not in AGG_DTYPES:
            raise ValueError(f"unknown agg_dtype {self.agg_dtype!r}")
        if self.sampler not in ("categorical", "indexed"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.guard is not None:
            as_guard(self.guard)
            if self.algo not in ("folb", "folb_het"):
                raise ValueError(
                    f"guard requires algo 'folb' or 'folb_het' (the guard "
                    f"runs inside the fused FOLB aggregation), got "
                    f"{self.algo!r}")
            if self.agg_backend != "flat":
                raise ValueError(
                    "guard requires agg_backend='flat' — the defenses are "
                    "streaming passes over the flat (K, D) buffers")
        missing = []
        if self.algo not in PORTED_ALGOS:
            missing.append(f"algo={self.algo!r}")
        if self.server_opt != "sgd" or self.server_lr != 1.0:
            missing.append("server optimizers")
        if self.telemetry:
            missing.append("telemetry")
        if self.sampler == "indexed":
            missing.append("sampler='indexed'")
        if missing:
            raise NotImplementedError(
                f"not ported yet: {', '.join(missing)}")


def local_step_draws(t: int, k: int, cfg) -> np.ndarray:
    """Per-round local-step budgets (paper Sec. VI-A) from the round-indexed
    numpy seed the reference uses, so both packages draw the same steps."""
    step_rng = np.random.default_rng(10_000 + t)
    if cfg.het_steps:
        return step_rng.integers(1, cfg.max_local_steps + 1,
                                 k).astype(np.int32)
    return np.full((k,), cfg.max_local_steps, np.int32)


def scenario_round_inputs(fl: FLConfig, rounds: int, scenario):
    """Realize an active scenario over a sync schedule, from the same
    numpy streams as the reference: the per-round step draws with the
    completeness channel applied, the fp32 upload mask (0.0 = transmission
    failed), the per-dispatch latency multiplier (None when jitter is off)
    and the per-dispatch payload-corruption factor (None when every payload
    channel is off).  Returns (steps (R, K) int32, up_mask (R, K) fp32,
    lat_scale or None, corrupt (R, K) fp32 or None)."""
    base = np.stack([local_step_draws(t, fl.n_selected, fl)
                     for t in range(rounds)])
    g = scenario_mod.realize(scenario, (rounds, fl.n_selected))
    steps = scenario_mod.scale_steps(base, g.comp)
    up_mask = (~g.drop).astype(np.float32)
    return steps, up_mask, g.lat_scale, g.corrupt


def _client_batch(data: Dict[str, torch.Tensor],
                  ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"x": data["x"][ids], "y": data["y"][ids],
            "mask": data["mask"][ids]}


def _local_updates(model_cfg, params: Params, data, ids: torch.Tensor,
                   n_steps: torch.Tensor, fl: FLConfig):
    """The K devices' local solves -> stacked (deltas, grads, gammas)."""
    return solvers.local_update(
        lambda p, b: small.small_loss(model_cfg, p, b), params,
        _client_batch(data, ids), lr=fl.lr, mu=fl.mu, n_steps=n_steps,
        max_steps=fl.max_local_steps)


def apply_corruption(deltas: Params, grads: Params, corrupt):
    """Scenario payload corruption: every leaf of device k's delta and
    gradient times ``corrupt[k]`` (NaN, ±scale_mag, −1, or exactly 1.0 for
    a benign payload, which leaves the row's bits unchanged).
    ``corrupt=None`` returns the inputs untouched."""
    if corrupt is None:
        return deltas, grads

    def mul(x):
        return x * corrupt.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)

    return ({k: mul(v) for k, v in deltas.items()},
            {k: mul(v) for k, v in grads.items()})


def _mask_guard(new: Params, params: Params, up_mask: torch.Tensor
                ) -> Params:
    """Keep the old parameters bit-for-bit when every selected upload
    dropped (``w + 0·x`` alone would flip the sign of negative zeros)."""
    alive = up_mask.sum() > 0.0
    return {k: torch.where(alive, new[k], params[k]) for k in new}


def _sync_aggregate(fl: FLConfig, params: Params, deltas: Params,
                    grads: Params, gammas: torch.Tensor, up_mask, tau0,
                    diag: Dict[str, Any]) -> Params:
    """Everything after the local updates of a cohort round (fedavg,
    fedprox, folb, folb_het).  Writes the guard's info dict into
    ``diag["guard"]`` when the guard is on."""
    if fl.algo in ("fedavg", "fedprox"):
        if up_mask is None:
            return aggregation.fedavg_aggregate(params, deltas)
        return _mask_guard(aggregation.mean_staleness(
            params, deltas, tau0, alpha=0.0, mask=up_mask), params, up_mask)
    if fl.agg_backend == "flat":
        # the hot path: flat (K, D) buffers through the kernels
        pg = fl.psi * gammas if fl.algo == "folb_het" else None
        buf_dtype = AGG_DTYPES[fl.agg_dtype]
        if up_mask is None:
            out = ops.folb_aggregate_tree(params, deltas, grads,
                                          psi_gammas=pg, buf_dtype=buf_dtype,
                                          guard=fl.guard)
        else:
            # the masked-slot staleness rule at τ = 0 is masked folb; it
            # keeps the parameters bit-exact when every row is masked
            out = ops.folb_staleness_slots_tree(
                params, deltas, grads, up_mask, tau0, alpha=0.0,
                psi_gammas=pg, buf_dtype=buf_dtype, guard=fl.guard)
        if fl.guard is not None:
            diag["guard"] = out[2]
        return out[0]
    gam = gammas if fl.algo == "folb_het" else None
    if up_mask is None:
        if gam is None:
            return aggregation.folb_single_set(params, deltas, grads)
        return aggregation.folb_het(params, deltas, grads, gam, fl.psi)
    return _mask_guard(aggregation.folb_staleness(
        params, deltas, grads, tau0, alpha=0.0, gammas=gam, psi=fl.psi,
        mask=up_mask), params, up_mask)


def fl_round(model_cfg, fl: FLConfig, params: Params,
             data: Dict[str, torch.Tensor], ids: torch.Tensor,
             n_steps: torch.Tensor, up_mask: Optional[torch.Tensor] = None,
             corrupt: Optional[torch.Tensor] = None):
    """One communication round over the (K,) device ``ids`` with (K,)
    local-step budgets.  Returns (new_params, diagnostics).

    ``up_mask`` is the scenario's drop channel: a (K,) fp32 mask, 0.0 on
    uploads that failed in transit; masked devices are excluded through
    each rule's mask form at τ = 0, α = 0.  ``corrupt`` is the payload-
    corruption channel: a (K,) fp32 factor applied to each device's
    uploaded delta and gradient.  With ``fl.guard`` the diagnostics carry
    the guard's info dict under ``diag["guard"]``.  ``None`` for either
    leaves the round exactly as without a scenario."""
    deltas, grads, gammas = _local_updates(model_cfg, params, data, ids,
                                           n_steps, fl)
    deltas, grads = apply_corruption(deltas, grads, corrupt)
    tau0 = None if up_mask is None else torch.zeros_like(up_mask)
    diag: Dict[str, Any] = {"gamma_mean": gammas.mean()}
    new = _sync_aggregate(fl, params, deltas, grads, gammas, up_mask, tau0,
                          diag)
    return new, diag


def eval_global(model_cfg, params: Params, data: Dict[str, torch.Tensor],
                p_weights: torch.Tensor):
    """Device-weighted global loss f(w) = Σ p_k F_k(w) and accuracy."""
    shared = {k: v.unsqueeze(0) for k, v in params.items()}
    losses = small.small_loss(model_cfg, shared, data)
    accs = small.small_accuracy(model_cfg, shared, data)
    return (losses * p_weights).sum(), (accs * p_weights).sum()


@dataclasses.dataclass
class FedRunResult:
    """Round history, final parameters and the (rounds, K) device ids.
    Mapping-style reads (``result["test_acc"]``) delegate to ``history``."""
    history: Dict[str, List[float]]
    params: Params
    ids: Optional[np.ndarray] = None

    def __getitem__(self, key: str) -> List[float]:
        return self.history[key]

    def __contains__(self, key: str) -> bool:
        return key in self.history
