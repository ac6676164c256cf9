"""Whole-run synchronous engine (``repro.fed.scan_engine``).

``run_federated_compiled`` mirrors the reference's scan engine: the round
ids and local-step budgets are drawn before the run, the parameters ride a
flat fp32 carry (``repro_torch.core.flat``; exact ravel/unravel round
trip), every round appends its post-update carry to a ``(rounds, D_pad)``
trajectory, and the history is evaluated afterwards at the same points the
reference evaluates (``eval_history_replay``).  The round loop itself never
waits for the device.

A failure scenario (``scenario=``, a ``repro_torch.sysmodel.
ScenarioConfig``) is realized once before the run from the reference's
numpy streams: its completeness channel scales the step budgets, its drop
channel becomes each round's upload mask and its payload channels each
round's corruption factors.  Jitter only scales a fleet's wall clock, and
the port has no fleet yet, so it has no effect (as in the reference with
``fleet=None``).  A null scenario runs the exact pre-scenario code.

JAX's threefry draws cannot be reproduced in torch, so the engine has two
test seams: ``ids=`` replays a given ``(rounds, K)`` id schedule in place
of the port's own sampler, and ``init_params=`` starts from given
parameters in place of the port's own init.  A plain call uses the port's
own generators, seeded from ``fl.seed``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import flat as flat_lib
from repro_torch.core import selection
from repro_torch.device import resolve
from repro_torch.fed import simulator
from repro_torch.models import small
from repro_torch.sysmodel import scenario as scenario_mod


def _generator(seed: int, stream: int) -> torch.Generator:
    """A CPU generator for one of the run's random streams (init, ids)."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def device_data(model_cfg, x, y, mask, device) -> Dict[str, torch.Tensor]:
    """Stacked numpy client data -> tensors on ``device`` (int64 tokens and
    labels, fp32 features and masks)."""
    xs = torch.as_tensor(np.asarray(x))
    xs = xs.long() if model_cfg.kind == "lstm" else xs.float()
    return {"x": xs.to(device),
            "y": torch.as_tensor(np.asarray(y)).long().to(device),
            "mask": torch.as_tensor(np.asarray(mask)).float().to(device)}


def _eval_points(rounds: int, eval_every: int):
    return [t for t in range(rounds)
            if t % eval_every == 0 or t == rounds - 1]


def eval_history_replay(model_cfg, spec: flat_lib.FlatSpec, train, test, p,
                        traj: torch.Tensor, rounds: int, eval_every: int):
    """History from the (rounds, D_pad) trajectory at the reference's eval
    points; one host transfer at the end."""
    ts = _eval_points(rounds, eval_every)
    rows = []
    for t in ts:
        params = flat_lib.unravel(spec, traj[t])
        tr_loss, tr_acc = simulator.eval_global(model_cfg, params, train, p)
        _, te_acc = simulator.eval_global(model_cfg, params, test, p)
        rows.append(torch.stack([tr_loss, te_acc, tr_acc]))
    vals = torch.stack(rows).double().cpu().numpy()
    return {"round": list(ts),
            "train_loss": [float(v) for v in vals[:, 0]],
            "test_acc": [float(v) for v in vals[:, 1]],
            "train_acc": [float(v) for v in vals[:, 2]]}


def run_federated_compiled(model_cfg, fed, fl: simulator.FLConfig,
                           rounds: int, *, eval_every: int = 1,
                           device=None, ids=None, init_params=None,
                           scenario=None) -> simulator.FedRunResult:
    """Run ``rounds`` synchronous rounds of ``fl`` on ``fed`` (any object
    with the ``FederatedData`` fields) under an optional failure
    ``scenario``.  ``device=None`` runs on the card.  ``ids``/
    ``init_params`` are the test seams described above."""
    sc = scenario_mod.as_active(scenario)
    if sc is not None:
        scenario_mod.check_sync(sc)
    dev = resolve(device)
    K = fl.n_selected
    if init_params is None:
        init_params = small.init_small(model_cfg, _generator(fl.seed, 0))
    params = {k: torch.as_tensor(np.array(v, np.float32)).to(dev)
              for k, v in init_params.items()}
    train = device_data(model_cfg, fed.x, fed.y, fed.mask, dev)
    test = device_data(model_cfg, fed.test_x, fed.test_y, fed.test_mask, dev)
    p = torch.as_tensor(np.asarray(fed.p)).float().to(dev)
    n_devices = train["x"].shape[0]
    if ids is None:
        ids = selection.sample_uniform_ids(_generator(fl.seed, 1),
                                           n_devices, K, rounds)
    ids = torch.tensor(np.asarray(ids), dtype=torch.int64)
    if ids.shape != (rounds, K):
        raise ValueError(f"ids must be ({rounds}, {K}), got "
                         f"{tuple(ids.shape)}")
    up_mask = corrupt = None
    if sc is None:
        steps = np.stack([simulator.local_step_draws(t, K, fl)
                          for t in range(rounds)])
    else:
        steps, mask_np, _, corr_np = simulator.scenario_round_inputs(
            fl, rounds, sc)
        up_mask = torch.as_tensor(mask_np).to(dev)
        if corr_np is not None:
            corrupt = torch.as_tensor(corr_np).to(dev)
    ids_dev = ids.to(dev)
    steps_dev = torch.as_tensor(steps).to(dev)

    spec = flat_lib.spec_of(params)
    w = flat_lib.ravel(spec, params)
    traj = torch.empty((rounds, spec.D_pad), dtype=torch.float32, device=dev)
    for t in range(rounds):
        new, _ = simulator.fl_round(
            model_cfg, fl, flat_lib.unravel(spec, w), train, ids_dev[t],
            steps_dev[t], up_mask=None if up_mask is None else up_mask[t],
            corrupt=None if corrupt is None else corrupt[t])
        w = flat_lib.ravel(spec, new)
        traj[t] = w
    hist = eval_history_replay(model_cfg, spec, train, test, p, traj,
                               rounds, eval_every)
    return simulator.FedRunResult(history=hist,
                                  params=flat_lib.unravel(spec, w),
                                  ids=ids.numpy())
