"""The port's front door: ``repro_torch.fed.run`` (``repro.fed.api``).

Dispatches on the config type like the reference.  The port runs the
synchronous engine only, so any config other than ``FLConfig`` raises; a
``scenario`` must be a ``repro_torch.sysmodel.ScenarioConfig`` (scenario
grids are not ported yet).
"""
from __future__ import annotations

from repro_torch.fed import scan_engine as _scan
from repro_torch.fed import simulator as _sim
from repro_torch.sysmodel import scenario as _scenario


def run(model_cfg, fed, cfg: _sim.FLConfig, rounds: int, *,
        eval_every: int = 1, device=None, ids=None, init_params=None,
        scenario=None) -> _sim.FedRunResult:
    """Run a federated configuration on ``device`` (``None``: the card).

    ``scenario`` (``repro_torch.sysmodel.ScenarioConfig``) injects the
    seeded failure channels, payload corruption included; the defence is
    the config's ``guard`` field (``repro_torch.kernels.GuardConfig``).
    ``ids`` (a ``(rounds, K)`` id schedule) and ``init_params`` (a dict of
    arrays) replace the port's own sampler and init: they let a test feed
    both packages identical inputs."""
    if scenario is not None and not isinstance(scenario,
                                               _scenario.ScenarioConfig):
        if type(scenario).__name__ == "ScenarioGrid":
            raise NotImplementedError("scenario grids (ScenarioGrid) are "
                                      "not ported yet")
        raise TypeError(
            f"scenario= must be a repro_torch.sysmodel.ScenarioConfig "
            f"(failure-injection channels), got {type(scenario).__name__}; "
            f"the defense knob is the config's guard field "
            f"(repro_torch.kernels.GuardConfig)")
    if not isinstance(cfg, _sim.FLConfig):
        raise TypeError(
            f"repro_torch.fed.run takes a repro_torch FLConfig (the sync "
            f"engine is the part ported so far), got {type(cfg).__name__}")
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    return _scan.run_federated_compiled(
        model_cfg, fed, cfg, rounds, eval_every=eval_every, device=device,
        ids=ids, init_params=init_params, scenario=scenario)
