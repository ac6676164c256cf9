"""The port's update guard and masked/stale aggregation
(repro_torch.kernels) against the reference's (repro.kernels).

  * ``guard_stats``'s plain version against the reference's Pallas
    ``guard_stats`` in interpret mode, with NaN and ±Inf planted in the
    deltas, the grads and both;
  * ``folb_aggregate_stale`` and ``folb_aggregate_stale_guarded`` (through
    ``ops.folb_staleness_buffers``) against the reference's on identical
    buffers and against the numpy oracle ``reference_guard``, for each
    defence alone and all together;
  * the all-rejected and all-masked contracts (parameters back bit-exact,
    -0.0 included) and the masked-slot contract (finite garbage in a masked
    row changes no bit).

Tolerances: both packages accumulate in fp32 over the same bf16/fp32
values and differ only in summation order, so norms and scores are held
to rtol 1e-5 and the unit-scale parameters to atol 1e-5.  The post-guard
mask, the finite flags and the three counters are decisions, held exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import folb_aggregate as rkern
from repro.kernels import guard as rguard
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import folb_aggregate as tkern
from repro_torch.kernels import guard as tguard
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

RTOL = 1e-5
ATOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GUARDS = {
    "nonfinite": dict(nonfinite=True),
    "clip": dict(nonfinite=False, clip_mult=3.0),
    "gate": dict(nonfinite=False, gate_mult=6.0),
    "all": dict(nonfinite=True, clip_mult=3.0, gate_mult=6.0),
}


def _to_torch(a) -> torch.Tensor:
    """numpy/jax array -> torch tensor with the same bits (fp32 or bf16)."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2:       # bf16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _both(x: np.ndarray, dtype: str):
    """One fp32 numpy array as (jax, torch) buffers of ``dtype``, same
    bits."""
    j = jnp.asarray(x).astype(DTYPES[dtype][0])
    return j, _to_torch(j)


def _plant(d: np.ndarray, g: np.ndarray):
    """NaN/+Inf in row 1's deltas, -Inf/NaN in row 2's grads, both in row
    3 (row 0 when K == 1), at lanes in the first and the last tile."""
    d, g = d.copy(), g.copy()
    K, D = d.shape
    rows = {1: "deltas", 2: "grads", 3: "both"} if K > 3 else {0: "both"}
    for r, where in rows.items():
        lo, hi = 37 * r % D, D - 1 - r
        if where in ("deltas", "both"):
            d[r, lo], d[r, hi] = np.nan, np.inf
        if where in ("grads", "both"):
            g[r, lo], g[r, hi] = -np.inf, np.nan
    return d, g


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("K,D", [(10, 1024), (4, 3 * 1024), (1, 2048)])
def test_guard_stats_plain_matches_pallas(K, D, dtype, planted):
    rng = np.random.default_rng(K * D)
    d = rng.normal(size=(K, D)).astype(np.float32)
    g = rng.normal(size=(K, D)).astype(np.float32)
    if planted:
        d, g = _plant(d, g)
    jd, td = _both(d, dtype)
    jg, tg = _both(g, dtype)
    want_n, want_f = rkern.guard_stats(jd, jg, interpret=True)
    got_n, got_f = tkern.guard_stats(td, tg)
    assert got_n.dtype == got_f.dtype == torch.float32
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=RTOL)
    assert np.isfinite(got_n.numpy()).all()
    if planted:
        bad = [1, 2, 3] if K > 3 else [0]
        assert (got_f.numpy()[bad] == 0.0).all()


def test_guard_stats_on_cpu_launches_nothing():
    d = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 1024)).astype(np.float32))
    before = tkern.guard_stats.launches
    n, f = tkern.guard_stats(d, d)
    assert tkern.guard_stats.launches == before
    assert torch.equal(f, torch.ones(3))
    assert torch.equal(n, tkern.guard_stats_plain(d, d)[0])


@pytest.mark.parametrize("case", ["shape", "dtype", "ragged_D", "fp16"])
def test_guard_stats_rejects_what_the_kernel_does_not_take(case):
    d, g = torch.zeros((2, 1024)), torch.zeros((2, 1024))
    if case == "shape":
        g = torch.zeros((3, 1024))
    elif case == "dtype":
        g = g.bfloat16()
    elif case == "ragged_D":
        d, g = torch.zeros((2, 1000)), torch.zeros((2, 1000))
    elif case == "fp16":
        d, g = d.half(), g.half()
    with pytest.raises(ValueError):
        tkern.guard_stats(d, g)


def _problem(K, seed, D=2048):
    """A staleness-FOLB problem with a NaN delta row, an Inf grad row, a
    norm-inflated row and a sign-flipped row among K >= 4, a partial
    mask, staleness and ψγ."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=D).astype(np.float32)
    base = rng.normal(size=D).astype(np.float32)
    grads = (0.1 * (base + rng.normal(size=(K, D)))).astype(np.float32)
    deltas = (0.1 * rng.normal(size=(K, D))).astype(np.float32)
    deltas[0, 5] = np.nan
    grads[1, D - 7] = np.inf
    deltas[2] *= 200.0
    grads[2] *= 200.0
    deltas[3] *= -1.0
    grads[3] *= -1.0
    mask = np.ones(K, np.float32)
    mask[K - 1] = 0.0
    tau = rng.integers(0, 4, size=K).astype(np.float32)
    pg = (0.1 * rng.random(K)).astype(np.float32)
    return w, deltas, grads, mask, tau, pg


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("K", [4, 10])
@pytest.mark.parametrize("which", sorted(GUARDS))
def test_guarded_aggregation_matches_reference(which, K, dtype):
    w, deltas, grads, mask, tau, pg = _problem(K, seed=K)
    jd, td = _both(deltas, dtype)
    jg, tg = _both(grads, dtype)
    rg, tgd = rguard.GuardConfig(**GUARDS[which]), \
        tguard.GuardConfig(**GUARDS[which])
    want_w, want_s, want_i = rops.folb_staleness_buffers(
        jnp.asarray(w), jd, jg, jnp.asarray(tau),
        jnp.asarray(0.5, jnp.float32), psi_gamma=jnp.asarray(pg),
        mask=jnp.asarray(mask), guard=rg)
    got_w, got_s, got_i = tops.folb_staleness_buffers(
        torch.from_numpy(w), td, tg, torch.from_numpy(tau), 0.5,
        psi_gamma=torch.from_numpy(pg), mask=torch.from_numpy(mask),
        guard=tgd)
    np.testing.assert_array_equal(got_i["mask"].numpy(),
                                  np.asarray(want_i["mask"]))
    for k in ("n_nonfinite", "n_clipped", "n_gated"):
        assert float(got_i[k]) == float(want_i[k]), k
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=ATOL)

    # the numpy oracle on the same buffer-rounded payloads
    oracle = tguard.reference_guard(td.float().numpy(), tg.float().numpy(),
                                    tau, 0.5, pg, mask, tgd)
    np.testing.assert_array_equal(got_i["mask"].numpy(), oracle["mask"])
    for k in ("n_nonfinite", "n_clipped", "n_gated"):
        assert float(got_i[k]) == oracle[k], k
    # conservation: every arrived row contributes, or is counted rejected
    n_contrib = float(got_i["mask"].sum())
    assert mask.sum() == n_contrib + float(got_i["n_nonfinite"]) * \
        tgd.nonfinite + float(got_i["n_gated"])


@pytest.mark.parametrize("which", sorted(GUARDS))
def test_reference_guard_copy_matches_reference(which):
    w, deltas, grads, mask, tau, pg = _problem(6, seed=21)
    got = tguard.reference_guard(deltas, grads, tau, 0.5, pg, mask,
                                 tguard.GuardConfig(**GUARDS[which]))
    want = rguard.reference_guard(deltas, grads, tau, 0.5, pg, mask,
                                  rguard.GuardConfig(**GUARDS[which]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))


@pytest.mark.parametrize("mask", [[1, 1, 1, 1, 1, 1], [1, 0, 1, 0, 1, 1],
                                  [0, 0, 0, 1, 0, 0], [0, 1, 1, 0, 0, 0],
                                  [0, 0, 0, 0, 0, 0]])
def test_masked_median_matches_reference(mask):
    x = np.array([3.0, 0.5, 7.0, 2.0, 9.0, 4.5], np.float32)
    m = np.asarray(mask, np.float32)
    want = float(rkern.masked_median(jnp.asarray(x), jnp.asarray(m)))
    got = tkern.masked_median(torch.from_numpy(x), torch.from_numpy(m))
    assert float(got) == want == tguard._np_masked_median(x, m)


@pytest.mark.parametrize("psi", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("K", [4, 10])
def test_stale_aggregation_matches_reference(K, dtype, psi):
    """Unguarded masked/stale FOLB, through ``ops`` and the kernel module,
    against the reference's Pallas path and oracle."""
    rng = np.random.default_rng(3 * K)
    D = 3 * 1024
    w = rng.normal(size=D).astype(np.float32)
    base = rng.normal(size=D).astype(np.float32)
    grads = (base + rng.normal(size=(K, D))).astype(np.float32)
    deltas = (0.1 * rng.normal(size=(K, D))).astype(np.float32)
    mask = (rng.random(K) < 0.7).astype(np.float32)
    mask[0] = 1.0
    tau = rng.integers(0, 5, size=K).astype(np.float32)
    pg = (0.2 * rng.random(K)).astype(np.float32) if psi \
        else np.zeros(K, np.float32)
    jd, td = _both(deltas, dtype)
    jg, tg = _both(grads, dtype)
    args_j = (jnp.asarray(w), jd, jg, jnp.asarray(tau),
              jnp.asarray(0.7, jnp.float32), jnp.asarray(pg),
              jnp.asarray(mask))
    args_t = (torch.from_numpy(w), td, tg, torch.from_numpy(tau), 0.7,
              torch.from_numpy(pg), torch.from_numpy(mask))
    want_w, want_s = rkern.folb_aggregate_stale(*args_j, interpret=True)
    got_w, got_s = tkern.folb_aggregate_stale(*args_t)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=ATOL)
    ops_w, ops_s = tops.folb_staleness_buffers(
        torch.from_numpy(w), td, tg, torch.from_numpy(tau), 0.7,
        psi_gamma=torch.from_numpy(pg), mask=torch.from_numpy(mask))
    assert torch.equal(ops_w, got_w) and torch.equal(ops_s, got_s)
    ref_w, ref_s = rref.folb_aggregate_stale_ref(*args_j)
    oref_w, oref_s = tref.folb_aggregate_stale_ref(*args_t)
    np.testing.assert_allclose(oref_s.numpy(), np.asarray(ref_s), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(oref_w.numpy(), np.asarray(ref_w), atol=ATOL)
    np.testing.assert_allclose(got_w.numpy(), oref_w.numpy(), atol=ATOL)


def test_guarded_buffers_route_through_stale_path():
    """``folb_aggregate_buffers(guard=...)`` is the guarded rule at τ = 0,
    α = 0 and a full mask, as in the reference."""
    w, deltas, grads, _, _, pg = _problem(5, seed=8)
    guard = tguard.GuardConfig(nonfinite=True, clip_mult=3.0)
    tw, td, tg = map(torch.from_numpy, (w, deltas, grads))
    got = tops.folb_aggregate_buffers(tw, td, tg,
                                      psi_gamma=torch.from_numpy(pg),
                                      guard=guard)
    want = tops.folb_staleness_buffers(tw, td, tg, torch.zeros(5), 0.0,
                                       psi_gamma=torch.from_numpy(pg),
                                       guard=guard)
    assert len(got) == 3
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[2]["n_nonfinite"]) == 2.0
    ref = rops.folb_aggregate_buffers(
        jnp.asarray(w), jnp.asarray(deltas), jnp.asarray(grads),
        psi_gamma=jnp.asarray(pg),
        guard=rguard.GuardConfig(nonfinite=True, clip_mult=3.0))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=ATOL)
    np.testing.assert_array_equal(got[2]["mask"].numpy(),
                                  np.asarray(ref[2]["mask"]))


def test_nonfinite_rows_never_reach_the_aggregate():
    """A NaN row is excluded whole: the result equals the run with that
    row hard-masked out, bit for bit."""
    w, deltas, grads, _, tau, pg = _problem(5, seed=9)
    deltas[0, 5] = 0.1                       # only the planted row is bad
    grads[1, -7] = 0.1
    bad = deltas.copy()
    bad[3] = np.nan
    guard = tguard.GuardConfig(nonfinite=True)
    args = (torch.from_numpy(w),)
    got, _, info = tops.folb_staleness_buffers(
        *args, torch.from_numpy(bad), torch.from_numpy(grads),
        torch.from_numpy(tau), 0.5, psi_gamma=torch.from_numpy(pg),
        mask=torch.ones(5), guard=guard)
    hard = torch.ones(5)
    hard[3] = 0.0
    want, _, _ = tops.folb_staleness_buffers(
        *args, torch.from_numpy(deltas), torch.from_numpy(grads),
        torch.from_numpy(tau), 0.5, psi_gamma=torch.from_numpy(pg),
        mask=hard, guard=guard)
    assert torch.isfinite(got).all()
    assert float(info["n_nonfinite"]) == 1.0
    assert torch.equal(got, want)


class TestAllRejected:
    def test_returns_params_bit_exact_including_negative_zero(self):
        K, D = 4, 1024
        w = np.array([0.0, -0.0, 1.5, -2.25] + [0.0] * (D - 4), np.float32)
        deltas = np.full((K, D), np.nan, np.float32)
        grads = np.ones((K, D), np.float32)
        new_w, _, ginfo = tops.folb_staleness_buffers(
            torch.from_numpy(w), torch.from_numpy(deltas),
            torch.from_numpy(grads), torch.zeros(K), 0.0, mask=torch.ones(K),
            guard=tguard.GuardConfig(nonfinite=True, clip_mult=3.0,
                                     gate_mult=6.0))
        got = new_w.numpy()
        assert (ginfo["mask"].numpy() == 0.0).all()
        assert float(ginfo["n_nonfinite"]) == float(K)
        np.testing.assert_array_equal(got, w)
        assert torch.equal(torch.signbit(new_w),
                           torch.signbit(torch.from_numpy(w)))

    def test_tree_front_end_all_rejected(self):
        params = {"a": torch.tensor([[-0.0, 1.0], [2.0, -0.0]]),
                  "b": torch.tensor([0.5, -0.5, -0.0])}
        K = 3
        bad = {k: torch.full((K,) + tuple(v.shape), float("nan"))
               for k, v in params.items()}
        new, _, ginfo = tops.folb_staleness_slots_tree(
            params, bad, bad, torch.ones(K), torch.zeros(K), alpha=0.0,
            guard=tguard.GuardConfig())
        for k in params:
            assert torch.equal(new[k], params[k])
            assert torch.equal(torch.signbit(new[k]),
                               torch.signbit(params[k]))
        assert float(ginfo["mask"].sum()) == 0.0


def _slot_problem(K, seed):
    rng = np.random.default_rng(seed)
    params = {"b": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32)),
              "w": torch.from_numpy(
                  rng.normal(size=(5, 7)).astype(np.float32))}
    deltas = {k: torch.from_numpy(
        (0.1 * rng.normal(size=(K,) + tuple(v.shape))).astype(np.float32))
        for k, v in params.items()}
    grads = {k: torch.from_numpy(
        rng.normal(size=(K,) + tuple(v.shape)).astype(np.float32))
        for k, v in params.items()}
    return params, deltas, grads


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("buf", ["float32", "bfloat16"])
def test_slots_masked_garbage_gives_same_bits(buf, guarded):
    """A masked slot enters every reduction as an exact 0.0·x, so any
    finite garbage there leaves the aggregate's bits unchanged."""
    K = 5
    params, deltas, grads = _slot_problem(K, seed=4)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])
    tau = torch.tensor([0.0, 3.0, 1.0, 0.0, 2.0])
    guard = tguard.GuardConfig(clip_mult=3.0) if guarded else None
    outs = []
    for garbage in (0.0, 1e3, -7.5):
        d = {k: v.clone() for k, v in deltas.items()}
        g = {k: v.clone() for k, v in grads.items()}
        for x in (d, g):
            for v in x.values():
                v[1] = garbage
                v[4] = -garbage
        new = tops.folb_staleness_slots_tree(
            params, d, g, mask, tau, alpha=0.5,
            buf_dtype=DTYPES[buf][1], guard=guard)[0]
        outs.append(new)
    for other in outs[1:]:
        for k in params:
            assert torch.equal(other[k], outs[0][k])


@pytest.mark.parametrize("guarded", [False, True])
def test_slots_all_masked_returns_params_bit_exact(guarded):
    K = 3
    params = {"a": torch.tensor([[-0.0, 1.0], [2.0, -0.0]]),
              "b": torch.tensor([0.5, -0.5, -0.0])}
    rng = np.random.default_rng(5)
    deltas, grads = ({k: torch.from_numpy(rng.normal(
        size=(K,) + tuple(v.shape)).astype(np.float32))
        for k, v in params.items()} for _ in range(2))
    out = tops.folb_staleness_slots_tree(
        params, deltas, grads, torch.zeros(K), torch.zeros(K), alpha=0.0,
        guard=tguard.GuardConfig() if guarded else None)
    assert len(out) == (3 if guarded else 2)
    for k in params:
        assert torch.equal(out[0][k], params[k])
        assert torch.equal(torch.signbit(out[0][k]),
                           torch.signbit(params[k]))


@pytest.mark.parametrize("guarded", [False, True])
def test_staleness_tree_matches_reference(guarded):
    """The dict front-end of the staleness rule, fp32 buffers, against the
    reference's."""
    K = 4
    params, deltas, grads = _slot_problem(K, seed=6)
    mask = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    tau = np.array([0.0, 2.0, 1.0, 3.0], np.float32)
    kw = dict(alpha=0.5, buf_dtype=torch.float32)
    got = tops.folb_staleness_tree(
        params, deltas, grads, torch.from_numpy(tau),
        mask=torch.from_numpy(mask),
        guard=tguard.GuardConfig(gate_mult=6.0) if guarded else None, **kw)
    jnp_tree = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    want = rops.folb_staleness_tree(
        jnp_tree, {k: jnp.asarray(v.numpy()) for k, v in deltas.items()},
        {k: jnp.asarray(v.numpy()) for k, v in grads.items()},
        jnp.asarray(tau), alpha=0.5, mask=jnp.asarray(mask),
        buf_dtype=jnp.float32,
        guard=rguard.GuardConfig(gate_mult=6.0) if guarded else None)
    assert len(got) == len(want)
    for k in params:
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]),
                                   atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=ATOL)


def test_guard_config_validation_matches_reference():
    with pytest.raises(ValueError, match="clip_mult"):
        tguard.GuardConfig(clip_mult=-1.0)
    with pytest.raises(ValueError, match="gate_mult"):
        tguard.GuardConfig(gate_mult=-0.5)
    with pytest.raises(ValueError, match="guard=None"):
        tguard.GuardConfig(nonfinite=False)
    g = tguard.GuardConfig(clip_mult=3.0)
    assert tguard.as_guard(None) is None
    assert tguard.as_guard(g) is g
    with pytest.raises(TypeError, match="GuardConfig"):
        tguard.as_guard(rguard.GuardConfig(clip_mult=3.0))
    assert len({g, tguard.GuardConfig(clip_mult=3.0),
                tguard.GuardConfig(gate_mult=2.0)}) == 2
    fields = [f.name for f in
              __import__("dataclasses").fields(tguard.GuardConfig)]
    assert fields == [f.name for f in
                      __import__("dataclasses").fields(rguard.GuardConfig)]
