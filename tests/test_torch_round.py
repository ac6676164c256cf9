"""The port's synchronous round and whole-run engine (repro_torch.fed)
against the reference (repro.fed).

  * one ``fl_round``, teacher-forced: both packages get the same params,
    the reference's sampled ids and the shared numpy local-step draws, for
    folb (bf16 and fp32 buffers), folb_het, fedavg and fedprox, on MCLR
    and a narrow LSTM, over three consecutive rounds of the reference's
    own trajectory;
  * a 3-round whole run with fp32 buffers: ``repro_torch.fed.run`` against
    ``repro.fed.run``, fed the reference's ids and initial parameters.

Tolerances: fp32 buffers follow the reference's fp32 flat-vs-pytree bound,
atol 1e-5 over 3 rounds (tests/test_flat.py).  With bf16 buffers the two
packages round the (K, D) buffers of slightly different fp32 deltas, so an
element can land one bf16 step apart; a round is held to the reference's
bf16 kernel tolerance, 5e-3 (tests/test_flat.py BF16_TOL).  bf16 is
compared per round only: the reference's own bf16 trajectory drifts
from its fp32 one by far more than that over 5 rounds, so no multi-round
bf16 bound is calibrated.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as rfed
from repro.configs import paper_models as rpm
from repro.data.federated import stack_devices
from repro.data.synthetic import char_stream, synthetic_alpha_beta
from repro.fed import simulator as rsim
from repro.models import small as rsmall
import repro_torch.fed as tfed
from repro_torch.configs import paper_models as tpm
from repro_torch.convert import from_reference
from repro_torch.fed import scan_engine as tscan
from repro_torch.fed import simulator as tsim
from repro_torch.kernels.guard import GuardConfig

torch.set_num_threads(2)

TOL = 1e-5
BF16_TOL = 5e-3
LSTM_NARROW = dataclasses.replace(rpm.LSTM, vocab=12, n_classes=12,
                                  seq_len=8, hidden=16, embed=8)


def _port_cfg(cfg):
    return tpm.SmallModelConfig(**dataclasses.asdict(cfg))


def _data(kind):
    if kind == "lstm":
        return LSTM_NARROW, stack_devices(char_stream(
            0, 8, vocab=12, seq_len=8, mean_size=20, n_classes=12), seed=0)
    return rpm.MCLR, stack_devices(
        synthetic_alpha_beta(0, 12, 1.0, 1.0, mean_size=40), seed=0)


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _assert_params_close(got, want, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol)


ROUND_CASES = [
    ("mclr", "folb", "bfloat16"), ("mclr", "folb", "float32"),
    ("mclr", "folb_het", "float32"), ("mclr", "folb_het", "bfloat16"),
    ("mclr", "fedavg", "float32"), ("mclr", "fedprox", "float32"),
    ("lstm", "folb", "bfloat16"), ("lstm", "folb", "float32"),
]


@pytest.mark.parametrize("kind,algo,agg_dtype", ROUND_CASES)
def test_fl_round_teacher_forced(kind, algo, agg_dtype):
    cfg, fed = _data(kind)
    mu = 0.0 if algo == "fedavg" else 1.0
    kw = dict(algo=algo, n_selected=4, mu=mu, psi=0.5, lr=0.05,
              max_local_steps=4, agg_dtype=agg_dtype, seed=1)
    rfl, tfl = rsim.FLConfig(**kw), tsim.FLConfig(**kw)
    train = {"x": jnp.asarray(fed.x), "y": jnp.asarray(fed.y),
             "mask": jnp.asarray(fed.mask)}
    p = jnp.asarray(fed.p)
    tcfg = _port_cfg(cfg)
    ttrain = tscan.device_data(tcfg, fed.x, fed.y, fed.mask, "cpu")
    params = rsmall.init_small(cfg, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    tol = BF16_TOL if agg_dtype == "bfloat16" else TOL
    for t in range(3):
        key, sub = jax.random.split(key)
        steps = rsim.local_step_draws(t, 4, rfl)
        want, diag = rsim.fl_round(cfg, rfl, params, train, p, sub, steps)
        got, _ = tsim.fl_round(
            tcfg, tfl, from_reference(_np_tree(params), device="cpu"),
            ttrain, torch.tensor(np.asarray(diag["ids"]), dtype=torch.int64),
            torch.from_numpy(tsim.local_step_draws(t, 4, tfl)))
        _assert_params_close(got, want, tol)
        params = want          # teacher forcing: both start from the same


def test_local_step_draws_match_reference():
    for het in (True, False):
        rfl = rsim.FLConfig(max_local_steps=7, het_steps=het)
        tfl = tsim.FLConfig(max_local_steps=7, het_steps=het)
        for t in (0, 1, 17):
            np.testing.assert_array_equal(
                tsim.local_step_draws(t, 10, tfl),
                np.asarray(rsim.local_step_draws(t, 10, rfl)))


@pytest.mark.parametrize("kind,algo", [("mclr", "folb"),
                                       ("mclr", "folb_het"),
                                       ("mclr", "fedprox"),
                                       ("lstm", "folb")])
def test_whole_run_fp32_matches_reference(kind, algo):
    cfg, fed = _data(kind)
    kw = dict(algo=algo, n_selected=4, psi=0.5, max_local_steps=4,
              agg_dtype="float32", seed=2)
    ref = rfed.run(cfg, fed, rsim.FLConfig(**kw), 3)
    init = _np_tree(rsmall.init_small(cfg, jax.random.PRNGKey(2)))
    got = tfed.run(_port_cfg(cfg), fed, tfed.FLConfig(**kw), 3,
                   device="cpu", ids=ref.ids, init_params=init)
    assert got.history["round"] == ref.history["round"]
    for key in ("train_loss", "test_acc", "train_acc"):
        np.testing.assert_allclose(got[key], ref[key], atol=TOL)
    _assert_params_close(got.params, ref.params, TOL)
    np.testing.assert_array_equal(got.ids, np.asarray(ref.ids))


def test_eval_every_points_match_reference():
    cfg, fed = _data("mclr")
    kw = dict(n_selected=3, max_local_steps=2, agg_dtype="float32")
    ref = rfed.run(cfg, fed, rsim.FLConfig(**kw), 5, eval_every=2)
    got = tfed.run(_port_cfg(cfg), fed, tfed.FLConfig(**kw), 5, eval_every=2,
                   device="cpu", ids=ref.ids,
                   init_params=_np_tree(rsmall.init_small(
                       cfg, jax.random.PRNGKey(0))))
    assert got.history["round"] == ref.history["round"] == [0, 2, 4]
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"],
                               atol=TOL)


def test_own_sampler_is_seeded_and_learns():
    """Without the seams the port draws its own ids and init from fl.seed:
    the same seed repeats the run exactly, and MCLR's loss falls."""
    _, fed = _data("mclr")
    fl = tfed.FLConfig(n_selected=4, max_local_steps=5, seed=3)
    a = tfed.run(tpm.MCLR, fed, fl, 4, device="cpu")
    b = tfed.run(tpm.MCLR, fed, fl, 4, device="cpu")
    assert a.ids.shape == (4, 4)
    assert a.ids.min() >= 0 and a.ids.max() < fed.n_devices
    np.testing.assert_array_equal(a.ids, b.ids)
    assert a["train_loss"] == b["train_loss"]
    assert a["train_loss"][-1] < a["train_loss"][0]
    assert all(np.isfinite(a["train_loss"]))


@pytest.mark.parametrize("field,value", [
    ("algo", "fednu_direct"), ("algo", "folb2"), ("guard", object()),
    ("server_opt", "adam"), ("server_lr", 0.5), ("telemetry", True),
    ("sampler", "indexed")])
def test_config_raises_on_what_is_not_ported(field, value):
    """Unported fields raise ``NotImplementedError``.  ``guard`` is
    ported: it is validated as in the reference (a ``GuardConfig``, folb or
    folb_het, flat backend), so a non-config raises ``TypeError`` and a bad
    combination ``ValueError``."""
    if field != "guard":
        with pytest.raises(NotImplementedError):
            tfed.FLConfig(**{field: value})
        return
    guard = GuardConfig(clip_mult=3.0)
    assert tfed.FLConfig(guard=guard).guard is guard
    tfed.FLConfig(algo="folb_het", psi=0.5, guard=guard)
    with pytest.raises(TypeError):
        tfed.FLConfig(guard=value)
    with pytest.raises(ValueError, match="guard requires algo"):
        tfed.FLConfig(algo="fedavg", guard=guard)
    with pytest.raises(ValueError, match="agg_backend='flat'"):
        tfed.FLConfig(agg_backend="pytree", guard=guard)
    for bad in (dict(nonfinite=False), dict(clip_mult=-1.0)):
        with pytest.raises(ValueError):
            GuardConfig(**bad)


def test_run_rejects_other_config_types():
    _, fed = _data("mclr")
    with pytest.raises(TypeError):
        tfed.run(tpm.MCLR, fed, rsim.FLConfig(), 1, device="cpu")


def test_default_device_is_the_card():
    """device=None means cuda: without a card the entry point raises
    rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    _, fed = _data("mclr")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfed.run(tpm.MCLR, fed, tfed.FLConfig(n_selected=2), 1)
