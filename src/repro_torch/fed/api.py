"""The port's front door: ``repro_torch.fed.run`` (``repro.fed.api``).

Dispatches on the config type like the reference.  This slice runs the
synchronous engine only, so any config other than ``FLConfig`` raises.
"""
from __future__ import annotations

from repro_torch.fed import scan_engine as _scan
from repro_torch.fed import simulator as _sim


def run(model_cfg, fed, cfg: _sim.FLConfig, rounds: int, *,
        eval_every: int = 1, device=None, ids=None, init_params=None
        ) -> _sim.FedRunResult:
    """Run a federated configuration on ``device`` (``None``: the card).

    ``ids`` (a ``(rounds, K)`` id schedule) and ``init_params`` (a dict of
    arrays) replace the port's own sampler and init: they let a test feed
    both packages identical inputs."""
    if not isinstance(cfg, _sim.FLConfig):
        raise TypeError(
            f"repro_torch.fed.run takes a repro_torch FLConfig (the sync "
            f"engine is the part ported so far), got {type(cfg).__name__}")
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    return _scan.run_federated_compiled(
        model_cfg, fed, cfg, rounds, eval_every=eval_every, device=device,
        ids=ids, init_params=init_params)
