"""Synchronous federated rounds, batched over clients
(``repro.fed.simulator``).

Ported so far: the cohort algorithms fedavg, fedprox, folb (the paper's
main method, Eq. IV-C) and folb_het (Eq. V-B), on the flat kernel backend
and the dict ("pytree") backend.  A round takes its device ids as a tensor,
like the reference's ``fl_round_cohort``: the engine draws them before the
run (or replays a given schedule).

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
from repro_torch.models import small
from repro_torch.optim import solvers

ALGOS = ("fedavg", "fedprox", "fednu_direct", "fednu_signed", "fednu_norm",
         "folb", "folb2", "folb_het")
PORTED_ALGOS = ("fedavg", "fedprox", "folb", "folb_het")
AGG_BACKENDS = ("flat", "pytree")
AGG_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """The reference's sync config; the fields this slice does not run
    raise ``NotImplementedError`` when set."""
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
        missing = []
        if self.algo not in PORTED_ALGOS:
            missing.append(f"algo={self.algo!r}")
        if self.guard is not None:
            missing.append("guard")
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


def fl_round(model_cfg, fl: FLConfig, params: Params,
             data: Dict[str, torch.Tensor], ids: torch.Tensor,
             n_steps: torch.Tensor):
    """One communication round over the (K,) device ``ids`` with (K,)
    local-step budgets.  Returns (new_params, diagnostics)."""
    deltas, grads, gammas = _local_updates(model_cfg, params, data, ids,
                                           n_steps, fl)
    if fl.algo in ("fedavg", "fedprox"):
        new = aggregation.fedavg_aggregate(params, deltas)
    elif fl.agg_backend == "flat":
        # the hot path: flat (K, D) buffers through the two kernels
        pg = fl.psi * gammas if fl.algo == "folb_het" else None
        new, _ = ops.folb_aggregate_tree(
            params, deltas, grads, psi_gammas=pg,
            buf_dtype=AGG_DTYPES[fl.agg_dtype])
    elif fl.algo == "folb":
        new = aggregation.folb_single_set(params, deltas, grads)
    else:
        new = aggregation.folb_het(params, deltas, grads, gammas, fl.psi)
    return new, {"gamma_mean": gammas.mean()}


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
