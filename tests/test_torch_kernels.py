"""The port's FOLB aggregation kernels (repro_torch.kernels) against the
reference's Pallas kernels run in interpret mode on the CPU.

On the CPU the wrappers run their plain PyTorch versions, so these tests
hold the plain versions (and the dispatch, validation and launch counting
around them) to the Pallas kernels on identical inputs: the same numpy
draws, with bf16 buffers handed over bit for bit.  The kernels themselves
run only on the card: tests/test_torch_cuda.py builds them and compares
them with the plain versions there.

Tolerances: both sides accumulate in fp32 over the same bf16/fp32 values
and differ only in summation order (Pallas: per-1024 tile then across
tiles; PyTorch: its own vectorised order).  Over D <= 8192 terms of unit
scale that moves a sum by a few fp32 ulps of its magnitude, so the scores
are held to rtol 1e-5 and the applied parameters (unit scale) to atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import folb_aggregate as rkern
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import folb_aggregate as tkern
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.guard import GuardConfig

torch.set_num_threads(2)

RTOL = 1e-5
ATOL = 1e-5
# (K, D_pad): the MCLR main-path shape, a single client, an odd tile
# count, and a wide cohort; D_pad <= 8 * 1024 keeps the interpret grid small
SHAPES = [(10, 1024), (1, 2048), (4, 7 * 1024), (64, 1024)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(a) -> torch.Tensor:
    """jax array -> torch tensor with the same bits (fp32 or bf16)."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2:       # bf16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _problem(K, D, dtype, seed):
    """Grads around a shared direction (so the scores are well away from
    zero, as on the main path), deltas, fp32 params, in both packages."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(D,)).astype(np.float32)
    grads = (base + rng.normal(size=(K, D))).astype(np.float32)
    deltas = (0.1 * rng.normal(size=(K, D))).astype(np.float32)
    w = rng.normal(size=(D,)).astype(np.float32)
    jdt = DTYPES[dtype][0]
    jg = jnp.asarray(grads).astype(jdt)
    jd = jnp.asarray(deltas).astype(jdt)
    g1 = jnp.mean(jg.astype(jnp.float32), axis=0)
    return (jnp.asarray(w), jd, jg, g1), (
        _to_torch(w), _to_torch(jd), _to_torch(jg), _to_torch(g1))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("K,D", SHAPES)
def test_scores_plain_matches_pallas(K, D, dtype):
    (_, _, jg, jg1), (_, _, tg, tg1) = _problem(K, D, dtype, seed=K + D)
    want = np.asarray(rkern.folb_scores(jg, jg1, interpret=True))
    got = tkern.folb_scores(tg, tg1)
    assert got.dtype == torch.float32 and tuple(got.shape) == (K,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("K,D", SHAPES)
def test_apply_plain_matches_pallas(K, D, dtype):
    (jw, jd, _, _), (tw, td, _, _) = _problem(K, D, dtype, seed=2 * K + D)
    weights = np.random.default_rng(K).normal(size=(K,)).astype(np.float32)
    weights /= np.abs(weights).sum()
    want = np.asarray(rkern.folb_apply(jw, jd, jnp.asarray(weights),
                                       interpret=True))
    got = tkern.folb_apply(tw, td, torch.from_numpy(weights))
    assert got.dtype == torch.float32 and tuple(got.shape) == (D,)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("psi", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("K,D", [(10, 1024), (4, 7 * 1024)])
def test_aggregate_buffers_match_reference(K, D, dtype, psi):
    """ops.folb_aggregate_buffers end to end (g1, ψγ·||g1||², normalizer,
    both passes), with and without the heterogeneity term."""
    (jw, jd, jg, _), (tw, td, tg, _) = _problem(K, D, dtype, seed=3 * K + D)
    pg = (np.random.default_rng(D).uniform(0.0, 0.5, size=(K,))
          .astype(np.float32) if psi else None)
    want_w, want_s = rops.folb_aggregate_buffers(
        jw, jd, jg, psi_gamma=None if pg is None else jnp.asarray(pg))
    got_w, got_s = tops.folb_aggregate_buffers(
        tw, td, tg, psi_gamma=None if pg is None else torch.from_numpy(pg))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=ATOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ref_matches_reference_ref(dtype):
    (jw, jd, jg, jg1), (tw, td, tg, tg1) = _problem(6, 3072, dtype, seed=11)
    pg = np.linspace(0.0, 0.3, 6).astype(np.float32)
    g1_sq = jnp.sum(jg1 * jg1)
    want_w, want_s = rref.folb_aggregate_ref(jw, jd, jg, jg1,
                                             jnp.asarray(pg), g1_sq)
    got_w, got_s = tref.folb_aggregate_ref(tw, td, tg, tg1,
                                           torch.from_numpy(pg),
                                           (tg1 * tg1).sum())
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=ATOL)


def test_kernel_composition_matches_plain_ref():
    """folb_aggregate (scores pass, normalizer, apply pass) == the plain
    oracle on the same buffers."""
    _, (tw, td, tg, tg1) = _problem(5, 2048, "bfloat16", seed=12)
    pg = torch.linspace(0.0, 0.2, 5)
    g1_sq = (tg1 * tg1).sum()
    got_w, got_s = tkern.folb_aggregate(tw, td, tg, tg1, pg, g1_sq)
    want_w, want_s = tref.folb_aggregate_ref(tw, td, tg, tg1, pg, g1_sq)
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), rtol=RTOL)
    np.testing.assert_allclose(got_w.numpy(), want_w.numpy(), atol=ATOL)


def test_cpu_tensors_run_plain_and_launch_nothing():
    _, (tw, td, tg, tg1) = _problem(3, 1024, "bfloat16", seed=13)
    before = (tkern.folb_scores.launches, tkern.folb_apply.launches)
    s = tkern.folb_scores(tg, tg1)
    out = tkern.folb_apply(tw, td, s / s.abs().sum())
    assert torch.equal(s, tkern.folb_scores_plain(tg, tg1))
    assert torch.equal(out, tkern.folb_apply_plain(tw, td, s / s.abs().sum()))
    assert (tkern.folb_scores.launches, tkern.folb_apply.launches) == before


@pytest.mark.parametrize("case", ["ragged_D", "fp16_grads", "g1_bf16",
                                  "g1_length", "grads_1d", "k_too_big"])
def test_scores_rejects_what_the_kernel_does_not_take(case):
    g = torch.zeros((2, 1024))
    g1 = torch.zeros(1024)
    if case == "ragged_D":
        g, g1 = torch.zeros((2, 1000)), torch.zeros(1000)
    elif case == "fp16_grads":
        g = g.half()
    elif case == "g1_bf16":
        g1 = g1.bfloat16()
    elif case == "g1_length":
        g1 = torch.zeros(2048)
    elif case == "grads_1d":
        g = torch.zeros(1024)
    elif case == "k_too_big":
        g = torch.zeros((tkern.MAX_K + 1, 1024))
    with pytest.raises(ValueError):
        tkern.folb_scores(g, g1)


@pytest.mark.parametrize("case", ["w_bf16", "weights_length", "ragged_D"])
def test_apply_rejects_what_the_kernel_does_not_take(case):
    w, d, wt = torch.zeros(1024), torch.zeros((2, 1024)), torch.zeros(2)
    if case == "w_bf16":
        w = w.bfloat16()
    elif case == "weights_length":
        wt = torch.zeros(3)
    elif case == "ragged_D":
        w, d = torch.zeros(1000), torch.zeros((2, 1000))
    with pytest.raises(ValueError):
        tkern.folb_apply(w, d, wt)


@pytest.mark.parametrize("kw", ["mesh", "guard"])
def test_ops_raise_on_unported_variants(kw):
    """``mesh=`` is not ported and raises.  ``guard=`` is ported: a
    ``GuardConfig`` runs and adds the guard's info to the return, anything
    else raises ``TypeError``, and a config that guards nothing raises
    ``ValueError``, as in the reference."""
    _, (tw, td, tg, _) = _problem(2, 1024, "float32", seed=14)
    if kw == "mesh":
        with pytest.raises(NotImplementedError):
            tops.folb_aggregate_buffers(tw, td, tg, mesh=object())
        return
    new_w, scores, ginfo = tops.folb_aggregate_buffers(
        tw, td, tg, guard=GuardConfig())
    assert new_w.shape == tw.shape and scores.shape == (2,)
    assert sorted(ginfo) == ["mask", "n_clipped", "n_gated", "n_nonfinite"]
    with pytest.raises(TypeError):
        tops.folb_aggregate_buffers(tw, td, tg, guard=object())
    with pytest.raises(ValueError):
        GuardConfig(nonfinite=False)
