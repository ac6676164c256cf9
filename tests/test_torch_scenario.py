"""Failure scenarios on the port's sync engine (repro_torch.sysmodel,
repro_torch.fed) against the reference (repro.sysmodel, repro.fed).

  * ``realize``, ``scale_steps`` and ``scenario_round_inputs`` give
    byte-identical arrays from the same config, the forced-benign rule for
    dropped dispatches included;
  * one ``fl_round``, teacher-forced under the realized upload mask and
    corruption factors: both packages get the same params, the reference's
    sampled ids and the shared local-step draws, guarded and unguarded, on
    the flat backend (bf16 and fp32 buffers), the pytree backend and
    fedavg/fedprox; the guard's post-mask and counters must be equal;
  * a 3-round whole run with fp32 buffers: ``repro_torch.fed.run`` against
    ``repro.fed.run(..., engine="scan", scenario=...)``, fed the
    reference's ids and initial parameters;
  * the front door's scenario validation.

Tolerances, as in tests/test_torch_round.py: fp32 buffers atol 1e-5 (the
reference's own fp32 flat-vs-pytree bound over 3 rounds); bf16 buffers
5e-3 per round (one bf16 step of a buffer element rounded from slightly
different fp32 deltas).  The whole runs add rtol 1e-6 (about 8 fp32 ulps):
where most of a round's arriving payloads are inflated, the median-based
guard cannot outvote them (as in the reference), the loss leaves unit
scale (161 in the corrupting MCLR run) and one fp32 ulp there is 1.5e-5.
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
from repro.kernels import guard as rguard
from repro.models import small as rsmall
from repro.sysmodel import scenario as rscen
import repro_torch.fed as tfed
from repro_torch.configs import paper_models as tpm
from repro_torch.convert import from_reference
from repro_torch.fed import scan_engine as tscan
from repro_torch.fed import simulator as tsim
from repro_torch.kernels import guard as tguard
from repro_torch.sysmodel import scenario as tscen

torch.set_num_threads(2)

TOL = 1e-5
RUN_RTOL = 1e-6
BF16_TOL = 5e-3
LSTM_NARROW = dataclasses.replace(rpm.LSTM, vocab=12, n_classes=12,
                                  seq_len=8, hidden=16, embed=8)
GUARD_KW = dict(nonfinite=True, clip_mult=5.0, gate_mult=20.0)
# rates high enough that drops, NaN and inflated payloads all fire within
# 3 rounds of K = 4 dispatches
CORRUPTING = dict(drop_prob=0.2, nan_prob=0.15, scale_prob=0.15,
                  scale_mag=100.0, seed=20)
DROP_ONLY = dict(drop_prob=0.3, seed=5)
SCENARIOS = {
    "off": dict(),
    "drop": dict(drop_prob=0.3, seed=1),
    "dropout": dict(dropout_prob=0.2, drop_prob=0.3, seed=2),
    "partial": dict(partial_prob=0.5, completeness_min=0.3, seed=4),
    "jitter": dict(jitter_sigma=0.4, seed=6),
    "corrupting": CORRUPTING,
    "dropped_corrupt": dict(drop_prob=0.6, nan_prob=0.5, scale_prob=0.3,
                            flip_prob=0.3, seed=7),
    "all": dict(drop_prob=0.1, partial_prob=0.3, jitter_sigma=0.2,
                nan_prob=0.05, scale_prob=0.05, flip_prob=0.05, seed=8),
}


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


def _assert_same_array(got, want):
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("shape", [(5, 4), (40, 10), (17,)])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_realize_same_bytes_as_reference(name, shape):
    got = tscen.realize(tscen.ScenarioConfig(**SCENARIOS[name]), shape)
    want = rscen.realize(rscen.ScenarioConfig(**SCENARIOS[name]), shape)
    for field in ("drop", "lost", "comp", "lat_scale", "corrupt"):
        _assert_same_array(getattr(got, field), getattr(want, field))
    if got.corrupt is not None:
        # a payload that never reaches aggregation stays benign
        assert (got.corrupt[got.drop | got.lost] == 1.0).all()


def test_scale_steps_same_as_reference():
    rng = np.random.default_rng(0)
    base = rng.integers(1, 21, size=(6, 10)).astype(np.int32)
    comp = np.where(rng.random((6, 10)) < 0.5,
                    rng.uniform(0.05, 1.0, (6, 10)), 1.0)
    got = tscen.scale_steps(base, comp)
    _assert_same_array(got, rscen.scale_steps(base, comp))
    assert (got[comp == 1.0] == base[comp == 1.0]).all()
    assert got.min() >= 1


@pytest.mark.parametrize("name", ["drop", "partial", "jitter", "corrupting",
                                  "all"])
def test_scenario_round_inputs_same_as_reference(name):
    kw = dict(n_selected=6, max_local_steps=9)
    got = tsim.scenario_round_inputs(tsim.FLConfig(**kw), 7,
                                     tscen.ScenarioConfig(**SCENARIOS[name]))
    want = rsim.scenario_round_inputs(rsim.FLConfig(**kw), 7,
                                      rscen.ScenarioConfig(**SCENARIOS[name]))
    for a, b in zip(got, want):
        _assert_same_array(a, None if b is None else np.asarray(b))


def test_config_properties_and_checks_match_reference():
    for kw in SCENARIOS.values():
        t, r = tscen.ScenarioConfig(**kw), rscen.ScenarioConfig(**kw)
        assert (t.active, t.corrupting) == (r.active, r.corrupting)
        assert (tscen.as_active(t) is None) == (rscen.as_active(r) is None)
    with pytest.raises(ValueError, match="synchronous"):
        tscen.check_sync(tscen.ScenarioConfig(dropout_prob=0.1))
    for bad in (dict(drop_prob=1.5), dict(completeness_min=0.0),
                dict(jitter_sigma=-1.0), dict(scale_mag=0.0)):
        with pytest.raises(ValueError):
            tscen.ScenarioConfig(**bad)
    assert [f.name for f in dataclasses.fields(tscen.ScenarioConfig)] == \
        [f.name for f in dataclasses.fields(rscen.ScenarioConfig)]


ROUND_CASES = [
    # (kind, algo, agg_dtype, backend, scenario, guarded)
    ("mclr", "folb", "float32", "flat", "corrupting", True),
    ("mclr", "folb", "bfloat16", "flat", "corrupting", True),
    ("mclr", "folb_het", "float32", "flat", "corrupting", True),
    ("mclr", "folb_het", "bfloat16", "flat", "corrupting", True),
    ("lstm", "folb", "float32", "flat", "corrupting", True),
    ("mclr", "folb", "float32", "flat", "drop", False),
    ("mclr", "folb", "bfloat16", "flat", "drop", False),
    ("mclr", "folb_het", "float32", "flat", "drop", False),
    ("mclr", "folb_het", "bfloat16", "flat", "drop", False),
    ("mclr", "folb", "float32", "pytree", "drop", False),
    ("mclr", "folb_het", "float32", "pytree", "drop", False),
    ("mclr", "fedavg", "float32", "flat", "drop", False),
    ("mclr", "fedprox", "float32", "flat", "drop", False),
]


@pytest.mark.parametrize("kind,algo,agg_dtype,backend,scen,guarded",
                         ROUND_CASES)
def test_fl_round_teacher_forced_under_scenario(kind, algo, agg_dtype,
                                                backend, scen, guarded):
    cfg, fed = _data(kind)
    K, rounds = 4, 3
    mu = 0.0 if algo == "fedavg" else 1.0
    kw = dict(algo=algo, n_selected=K, mu=mu, psi=0.5, lr=0.05,
              max_local_steps=4, agg_dtype=agg_dtype, agg_backend=backend,
              seed=1)
    rfl = rsim.FLConfig(**kw, guard=rguard.GuardConfig(**GUARD_KW)
                        if guarded else None)
    tfl = tsim.FLConfig(**kw, guard=tguard.GuardConfig(**GUARD_KW)
                        if guarded else None)
    sc_kw = CORRUPTING if scen == "corrupting" else DROP_ONLY
    steps, up_mask, _, corrupt = tsim.scenario_round_inputs(
        tfl, rounds, tscen.ScenarioConfig(**sc_kw))
    assert (up_mask == 0.0).any()
    assert (corrupt is not None) == (scen == "corrupting")
    train = {"x": jnp.asarray(fed.x), "y": jnp.asarray(fed.y),
             "mask": jnp.asarray(fed.mask)}
    p = jnp.asarray(fed.p)
    tcfg = _port_cfg(cfg)
    ttrain = tscan.device_data(tcfg, fed.x, fed.y, fed.mask, "cpu")
    params = rsmall.init_small(cfg, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    tol = BF16_TOL if agg_dtype == "bfloat16" else TOL
    for t in range(rounds):
        key, sub = jax.random.split(key)
        corr_t = None if corrupt is None else corrupt[t]
        want, diag = rsim.fl_round(
            cfg, rfl, params, train, p, sub, jnp.asarray(steps[t]),
            up_mask=jnp.asarray(up_mask[t]),
            corrupt=None if corr_t is None else jnp.asarray(corr_t))
        got, tdiag = tsim.fl_round(
            tcfg, tfl, from_reference(_np_tree(params), device="cpu"),
            ttrain, torch.tensor(np.asarray(diag["ids"]), dtype=torch.int64),
            torch.from_numpy(steps[t]),
            up_mask=torch.from_numpy(up_mask[t]),
            corrupt=None if corr_t is None else torch.from_numpy(corr_t))
        _assert_params_close(got, want, tol)
        assert ("guard" in tdiag) == ("guard" in diag) == guarded
        if guarded:
            np.testing.assert_array_equal(tdiag["guard"]["mask"].numpy(),
                                          np.asarray(diag["guard"]["mask"]))
            for k in ("n_nonfinite", "n_clipped", "n_gated"):
                assert float(tdiag["guard"][k]) == float(diag["guard"][k])
        params = want          # teacher forcing: both start from the same


def test_corruption_fired_in_the_guarded_rounds():
    """The guarded teacher-forced cases see NaN and inflated payloads that
    arrive, so the guard has work to do."""
    _, up_mask, _, corrupt = tsim.scenario_round_inputs(
        tsim.FLConfig(n_selected=4), 3, tscen.ScenarioConfig(**CORRUPTING))
    arrived = up_mask > 0.0
    assert (np.isnan(corrupt) & arrived).any()
    assert ((corrupt == 100.0) & arrived).any()


def test_all_uploads_dropped_keeps_params_bit_exact():
    cfg, fed = _data("mclr")
    tcfg = _port_cfg(cfg)
    train = tscan.device_data(tcfg, fed.x, fed.y, fed.mask, "cpu")
    params = from_reference(_np_tree(rsmall.init_small(
        cfg, jax.random.PRNGKey(3))), device="cpu")
    params["b"][0] = -0.0
    for algo, backend, guard in (("folb", "flat", None),
                                 ("folb", "flat", tguard.GuardConfig()),
                                 ("folb_het", "pytree", None),
                                 ("fedprox", "flat", None)):
        fl = tsim.FLConfig(algo=algo, n_selected=3, max_local_steps=2,
                           agg_backend=backend, guard=guard)
        new, _ = tsim.fl_round(tcfg, fl, params, train,
                               torch.tensor([0, 1, 2]),
                               torch.tensor([2, 1, 2], dtype=torch.int32),
                               up_mask=torch.zeros(3))
        for k in params:
            assert torch.equal(new[k], params[k])
            assert torch.equal(torch.signbit(new[k]),
                               torch.signbit(params[k]))


RUN_CASES = [
    # (kind, algo, scenario, guarded)
    ("mclr", "folb", "corrupting", True),
    ("mclr", "folb_het", "corrupting", True),
    ("lstm", "folb", "corrupting", True),
    ("mclr", "folb", "all", True),
    ("mclr", "folb", "drop", False),
    ("mclr", "folb", "partial", False),
    ("mclr", "folb", "jitter", False),
    ("mclr", "fedprox", "drop", False),
]


@pytest.mark.parametrize("kind,algo,scen,guarded", RUN_CASES)
def test_whole_run_under_scenario_matches_reference(kind, algo, scen,
                                                    guarded):
    cfg, fed = _data(kind)
    kw = dict(algo=algo, n_selected=4, psi=0.5, max_local_steps=4,
              agg_dtype="float32", seed=2)
    rfl = rsim.FLConfig(**kw, guard=rguard.GuardConfig(**GUARD_KW)
                        if guarded else None)
    tfl = tfed.FLConfig(**kw, guard=tguard.GuardConfig(**GUARD_KW)
                        if guarded else None)
    ref = rfed.run(cfg, fed, rfl, 3, engine="scan",
                   scenario=rscen.ScenarioConfig(**SCENARIOS[scen]))
    init = _np_tree(rsmall.init_small(cfg, jax.random.PRNGKey(2)))
    got = tfed.run(_port_cfg(cfg), fed, tfl, 3, device="cpu", ids=ref.ids,
                   init_params=init,
                   scenario=tscen.ScenarioConfig(**SCENARIOS[scen]))
    assert got.history["round"] == ref.history["round"]
    for key in ("train_loss", "test_acc", "train_acc"):
        np.testing.assert_allclose(got[key], ref[key], atol=TOL,
                                   rtol=RUN_RTOL)
    for k in ref.params:
        np.testing.assert_allclose(got.params[k].numpy(),
                                   np.asarray(ref.params[k]), atol=TOL,
                                   rtol=RUN_RTOL)


def test_null_scenario_is_the_pre_scenario_run():
    """An all-off scenario runs exactly the code of ``scenario=None``."""
    _, fed = _data("mclr")
    fl = tfed.FLConfig(n_selected=3, max_local_steps=3, seed=4)
    a = tfed.run(tpm.MCLR, fed, fl, 3, device="cpu")
    b = tfed.run(tpm.MCLR, fed, fl, 3, device="cpu",
                 scenario=tscen.ScenarioConfig(seed=9))
    assert a["train_loss"] == b["train_loss"]
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])


def test_run_rejects_what_the_sync_engine_does_not_take():
    _, fed = _data("mclr")
    fl = tfed.FLConfig(n_selected=2, max_local_steps=2)
    with pytest.raises(TypeError, match="ScenarioConfig"):
        tfed.run(tpm.MCLR, fed, fl, 1, device="cpu",
                 scenario=rscen.ScenarioConfig(drop_prob=0.1))
    with pytest.raises(TypeError, match="ScenarioConfig"):
        tfed.run(tpm.MCLR, fed, fl, 1, device="cpu",
                 scenario={"drop_prob": 0.1})
    with pytest.raises(NotImplementedError, match="not ported"):
        tfed.run(tpm.MCLR, fed, fl, 1, device="cpu",
                 scenario=rscen.ScenarioGrid(
                     (rscen.ScenarioConfig(drop_prob=0.1),)))
    with pytest.raises(ValueError, match="synchronous"):
        tfed.run(tpm.MCLR, fed, fl, 1, device="cpu",
                 scenario=tscen.ScenarioConfig(dropout_prob=0.1))
