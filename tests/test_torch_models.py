"""The port's paper models and local solver (repro_torch.models.small,
repro_torch.optim.solvers) against the reference for MCLR, MLP and a
narrow LSTM: per-client loss, accuracy and gradient, and local_update's
(Δ, ∇F(w^t), γ) for a cohort with heterogeneous step budgets.

Parameters and data are numpy draws from fixed seeds handed to both
packages (the port's batched functions get a leading client axis where
the reference is vmapped).  Tolerances: the two frameworks evaluate the
same fp32 expressions with different kernels (matmul blocking, exp/log/
tanh implementations), a few ulps apart per operation.  Losses and
gradients are held to rtol 1e-5 / atol 1e-6; local_update compounds them
over up to 5 prox-SGD steps and is held to atol 1e-5 — the reference's
own fp32 flat-vs-pytree bound (tests/test_flat.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as rpm
from repro.models import small as rsmall
from repro.optim import solvers as rsolvers
from repro_torch.configs import paper_models as tpm
from repro_torch.models import small as tsmall
from repro_torch.optim import solvers as tsolvers

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
STEP_ATOL = 1e-5
LSTM_NARROW = dataclasses.replace(rpm.LSTM, vocab=12, n_classes=12,
                                  seq_len=8, hidden=16, embed=8)
MLP_NARROW = dataclasses.replace(rpm.MLP, hidden=16)
MODELS = {"mclr": rpm.MCLR, "mlp": MLP_NARROW, "lstm": LSTM_NARROW}


def _port_cfg(cfg):
    return tpm.SmallModelConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed, k=0):
    """Numpy parameters of the reference's leaf names and shapes, at a
    scale that keeps logits O(1) (leading client axis k when k > 0)."""
    shapes = jax.eval_shape(lambda: rsmall.init_small(
        cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    return {n: (0.3 * rng.normal(size=((k,) if k else ()) + tuple(s.shape))
                ).astype(np.float32) for n, s in shapes.items()}


def _batch(cfg, seed, k, m=6):
    """(k, m, ...) client batches with some masked-out rows."""
    rng = np.random.default_rng(seed)
    if cfg.kind == "lstm":
        x = rng.integers(0, cfg.vocab, size=(k, m, cfg.seq_len))
    else:
        x = rng.normal(size=(k, m, cfg.n_features)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, size=(k, m)).astype(np.int32)
    mask = np.ones((k, m), np.float32)
    mask[:, m - 2:] = 0.0
    mask[0, 1] = 0.0
    return {"x": x.astype(np.int32) if cfg.kind == "lstm" else x,
            "y": y, "mask": mask}


def _tbatch(batch):
    x = torch.from_numpy(batch["x"])
    return {"x": x.long() if x.dtype == torch.int32 else x,
            "y": torch.from_numpy(batch["y"]).long(),
            "mask": torch.from_numpy(batch["mask"])}


def _tparams(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_loss_accuracy_and_grad_match(model):
    cfg, K = MODELS[model], 3
    p, batch = _params(cfg, 0, k=K), _batch(cfg, 1, K)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    loss_r = jax.vmap(lambda q, b: rsmall.small_loss(cfg, q, b))(jp, jb)
    acc_r = jax.vmap(lambda q, b: rsmall.small_accuracy(cfg, q, b))(jp, jb)
    grad_r = jax.vmap(jax.grad(
        lambda q, b: rsmall.small_loss(cfg, q, b)))(jp, jb)

    tcfg, tb = _port_cfg(cfg), _tbatch(batch)
    loss_t = tsmall.small_loss(tcfg, _tparams(p), tb)
    acc_t = tsmall.small_accuracy(tcfg, _tparams(p), tb)
    grad_t = tsolvers.grad_of(lambda q: tsmall.small_loss(tcfg, q, tb),
                              _tparams(p))
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_r),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_r))
    assert sorted(grad_t) == sorted(grad_r)
    for k in grad_r:
        np.testing.assert_allclose(grad_t[k].numpy(), np.asarray(grad_r[k]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_shared_params_broadcast_over_clients(model):
    """P == 1 parameters (global evaluation) give each row the loss of
    the same parameters stacked K times."""
    cfg, K = MODELS[model], 3
    tcfg = _port_cfg(cfg)
    p = _tparams(_params(cfg, 2))
    tb = _tbatch(_batch(cfg, 3, K))
    shared = tsmall.small_loss(tcfg, {k: v[None] for k, v in p.items()}, tb)
    stacked = tsmall.small_loss(
        tcfg, {k: v.expand((K,) + v.shape) for k, v in p.items()}, tb)
    np.testing.assert_allclose(shared.numpy(), stacked.numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mu", [0.0, 1.0])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_local_update_matches(model, mu):
    cfg, K, max_steps, lr = MODELS[model], 4, 5, 0.1
    w_ref, batch = _params(cfg, 4), _batch(cfg, 5, K)
    n_steps = np.array([1, 5, 3, 2], np.int32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jw = {k: jnp.asarray(v) for k, v in w_ref.items()}

    def one(x, y, m, steps):
        return rsolvers.local_update(
            lambda q, b: rsmall.small_loss(cfg, q, b), jw,
            {"x": x, "y": y, "mask": m}, lr=lr, mu=mu, n_steps=steps,
            max_steps=max_steps)

    d_r, g_r, gam_r = jax.vmap(one)(jb["x"], jb["y"], jb["mask"],
                                    jnp.asarray(n_steps))
    tcfg = _port_cfg(cfg)
    d_t, g_t, gam_t = tsolvers.local_update(
        lambda q, b: tsmall.small_loss(tcfg, q, b), _tparams(w_ref),
        _tbatch(batch), lr=lr, mu=mu, n_steps=torch.from_numpy(n_steps),
        max_steps=max_steps)
    for k in d_r:
        np.testing.assert_allclose(d_t[k].numpy(), np.asarray(d_r[k]),
                                   atol=STEP_ATOL)
        np.testing.assert_allclose(g_t[k].numpy(), np.asarray(g_r[k]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gam_t.numpy(), np.asarray(gam_r),
                               atol=STEP_ATOL)
    assert bool(((gam_t >= 0) & (gam_t <= 1)).all())


def test_masked_steps_leave_params_unchanged():
    """A client with n_steps = 0 runs max_steps masked steps: Δ is exactly
    zero, as in the reference's fixed-length scan."""
    cfg = MODELS["mlp"]
    tcfg = _port_cfg(cfg)
    d, _, _ = tsolvers.local_update(
        lambda q, b: tsmall.small_loss(tcfg, q, b), _tparams(_params(cfg, 6)),
        _tbatch(_batch(cfg, 7, 2)), lr=0.1, mu=1.0,
        n_steps=torch.tensor([0, 2]), max_steps=4)
    for v in d.values():
        assert bool((v[0] == 0).all()) and bool((v[1] != 0).any())


@pytest.mark.parametrize("model", sorted(MODELS))
def test_init_small_names_shapes_and_seeding(model):
    cfg = MODELS[model]
    ref = rsmall.init_small(cfg, jax.random.PRNGKey(0))
    a = tsmall.init_small(_port_cfg(cfg), torch.Generator().manual_seed(3))
    b = tsmall.init_small(_port_cfg(cfg), torch.Generator().manual_seed(3))
    assert sorted(a) == sorted(ref)
    for k in ref:
        assert tuple(a[k].shape) == ref[k].shape
        assert a[k].dtype == torch.float32
        assert torch.equal(a[k], b[k])
        if not np.any(np.asarray(ref[k])):      # zero-initialised leaves
            assert not bool(a[k].any())
