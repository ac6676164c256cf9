"""The port's flat layout (repro_torch.core.flat) against the reference
(repro.core.flat): the same parameter values ravel to the same bits in fp32
and bf16 buffers, for the MCLR, MLP and LSTM parameter dicts, and unravel
back to the same leaves.  Inputs are numpy draws from fixed seeds; bf16
rounding is round-to-nearest-even in both packages, so no tolerance is
needed: every comparison is exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as rpm
from repro.core import flat as rflat
from repro.models import small as rsmall
from repro_torch.core import flat as tflat

torch.set_num_threads(2)

LSTM_NARROW = dataclasses.replace(rpm.LSTM, vocab=12, n_classes=12,
                                  seq_len=8, hidden=16, embed=8)
MODELS = {"mclr": rpm.MCLR, "mlp": rpm.MLP, "lstm": LSTM_NARROW}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _params_np(cfg, seed: int, k: int = 0):
    """Numpy parameters with the model's leaf names and shapes (leading
    client axis k when k > 0).  Some entries sit exactly halfway between
    two bf16 values so round-half-to-even is exercised."""
    shapes = jax.eval_shape(lambda: rsmall.init_small(
        cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    out = {}
    for name, sd in shapes.items():
        shape = ((k,) if k else ()) + tuple(sd.shape)
        x = rng.normal(size=shape).astype(np.float32)
        flat = x.reshape(-1)
        flat[::7] = np.float32(1.0 + 2.0 ** -8) * np.sign(flat[::7])
        flat[::11] = np.float32(1.0 + 3 * 2.0 ** -8)
        flat[::13] *= np.float32(1e-30)
        out[name] = x
    return out


def _bits(a) -> np.ndarray:
    """Bit pattern of a jax array or torch tensor (fp32 or bf16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _torch(params_np):
    return {k: torch.from_numpy(v.copy()) for k, v in params_np.items()}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_spec_matches_reference(model):
    p = _params_np(MODELS[model], 0)
    rs = rflat.spec_of(p)
    ts = tflat.spec_of(_torch(p))
    leaves, _ = jax.tree_util.tree_flatten(p)
    assert [tuple(x.shape) for x in leaves] == list(ts.shapes)
    assert list(ts.names) == sorted(p)
    assert (ts.D, ts.D_pad) == (rs.D, rs.D_pad)
    assert ts.D_pad % tflat.TILE_D == 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_ravel_bit_equal(model, dtype):
    jdt, tdt = DTYPES[dtype]
    p = _params_np(MODELS[model], 1)
    rvec = rflat.ravel(rflat.spec_of(p, buf_dtype=jdt), p)
    tvec = tflat.ravel(tflat.spec_of(_torch(p), buf_dtype=tdt), _torch(p))
    assert tvec.dtype == tdt and tuple(tvec.shape) == rvec.shape
    np.testing.assert_array_equal(_bits(tvec), _bits(rvec))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_ravel_stacked_bit_equal(model, dtype):
    jdt, tdt = DTYPES[dtype]
    single = _params_np(MODELS[model], 2)
    stacked = _params_np(MODELS[model], 3, k=3)
    rspec = rflat.spec_of(single, buf_dtype=jdt)
    tspec = tflat.spec_of(_torch(single), buf_dtype=tdt)
    rbuf = rflat.ravel_stacked(rspec, stacked)
    tbuf = tflat.ravel_stacked(tspec, _torch(stacked))
    assert tuple(tbuf.shape) == rbuf.shape == (3, rspec.D_pad)
    np.testing.assert_array_equal(_bits(tbuf), _bits(rbuf))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_unravel_bit_equal(model, dtype):
    """unravel of the raveled buffer gives the reference's leaves, and the
    fp32 round trip is exact."""
    jdt, tdt = DTYPES[dtype]
    p = _params_np(MODELS[model], 4)
    rspec = rflat.spec_of(p, buf_dtype=jdt)
    tspec = tflat.spec_of(_torch(p), buf_dtype=tdt)
    rback = rflat.unravel(rspec, rflat.ravel(rspec, p))
    tback = tflat.unravel(tspec, tflat.ravel(tspec, _torch(p)))
    assert sorted(tback) == sorted(rback)
    for k in rback:
        assert tback[k].dtype == torch.float32
        np.testing.assert_array_equal(_bits(tback[k]), _bits(rback[k]))
        if dtype == "float32":
            np.testing.assert_array_equal(tback[k].numpy(), p[k])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_unravel_stacked_bit_equal(model, dtype):
    jdt, tdt = DTYPES[dtype]
    single = _params_np(MODELS[model], 5)
    stacked = _params_np(MODELS[model], 6, k=2)
    rspec = rflat.spec_of(single, buf_dtype=jdt)
    tspec = tflat.spec_of(_torch(single), buf_dtype=tdt)
    rback = rflat.unravel_stacked(
        rspec, rflat.ravel_stacked(rspec, stacked))
    tback = tflat.unravel_stacked(
        tspec, tflat.ravel_stacked(tspec, _torch(stacked)))
    for k in rback:
        assert tuple(tback[k].shape) == rback[k].shape
        np.testing.assert_array_equal(_bits(tback[k]), _bits(rback[k]))


def test_padding_lanes_are_zero():
    p = _torch(_params_np(rpm.MCLR, 7))
    spec = tflat.spec_of(p, buf_dtype=torch.bfloat16)
    vec = tflat.ravel(spec, p)
    assert spec.D == 610 and spec.D_pad == 1024
    assert bool((vec[spec.D:] == 0).all())
