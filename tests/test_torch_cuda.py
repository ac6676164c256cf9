"""The port's hand-written kernels on the card: each against its plain
PyTorch version on the same CUDA tensors (``guard_stats`` also on inputs
with NaN and ±Inf planted), and the launch counters.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither jax nor the JAX package, so it also runs on a machine
that has only PyTorch (``--noconftest`` skips the suite's JAX fixtures):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerance: rtol 1e-5 / atol 1e-6, as in chip_smoke.py; kernel and plain
version sum the same fp32 products in another order.  ``guard_stats``'s
finite flags must match exactly.
"""
import pytest
import torch

from repro_torch.kernels import folb_aggregate as tkern
from repro_torch.kernels import ops as tops
from repro_torch.kernels.guard import GuardConfig

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(10, 1024), (10, 114_688), (1, 2048), (64, 1024), (4, 7 * 1024)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _problem(K, D, dtype, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    base = torch.randn(D, generator=gen)
    grads = (base + torch.randn((K, D), generator=gen)).to(dev, dtype)
    deltas = (0.1 * torch.randn((K, D), generator=gen)).to(dev, dtype)
    w = torch.randn(D, generator=gen).to(dev)
    return w, deltas, grads, grads.float().mean(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("K,D", SHAPES)
def test_kernels_match_plain_on_card(K, D, dtype):
    dev = _card()
    w, d, g, g1 = _problem(K, D, DTYPES[dtype], K * D, dev)
    s = tkern.folb_scores(g, g1)
    torch.testing.assert_close(s, tkern.folb_scores_plain(g, g1),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(s, tkern.folb_scores(g, g1))     # no float atomics
    wt = s / s.abs().sum()
    torch.testing.assert_close(tkern.folb_apply(w, d, wt),
                               tkern.folb_apply_plain(w, d, wt),
                               rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()


def _plant(d, g):
    """NaN/+Inf/-Inf in row 1's deltas, row 2's grads and both of row 3,
    at lanes in the first and the last tile."""
    d, g = d.clone(), g.clone()
    D = d.shape[1]
    nan, inf = float("nan"), float("inf")
    d[1, 5], d[1, D - 3] = nan, inf
    g[2, 700], g[2, D - 1] = -inf, nan
    d[3, 0], g[3, D - 2] = -inf, inf
    return d, g


@pytest.mark.cuda
@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("K,D", [s for s in SHAPES if s[0] >= 4])
def test_guard_stats_matches_plain_on_card(K, D, dtype, planted):
    dev = _card()
    _, d, g, _ = _problem(K, D, DTYPES[dtype], K + D, dev)
    if planted:
        d, g = _plant(d, g)
    norms, fin = tkern.guard_stats(d, g)
    want_n, want_f = tkern.guard_stats_plain(d, g)
    assert torch.equal(fin, want_f)
    torch.testing.assert_close(norms, want_n, rtol=RTOL, atol=ATOL)
    again = tkern.guard_stats(d, g)                    # no float atomics
    assert torch.equal(norms, again[0]) and torch.equal(fin, again[1])
    if planted:
        assert fin[1:4].tolist() == [0.0, 0.0, 0.0]
        assert bool(torch.isfinite(norms).all())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_card_launches_are_counted():
    dev = _card()
    w, d, g, _ = _problem(4, 2048, torch.bfloat16, 15, dev)
    tkern.reset_launches()
    tops.folb_aggregate_buffers(w, d, g)
    torch.cuda.synchronize()
    assert (tkern.folb_scores.launches, tkern.folb_apply.launches,
            tkern.guard_stats.launches) == (1, 1, 0)
    tops.folb_aggregate_buffers(w, d, g, guard=GuardConfig(clip_mult=3.0))
    torch.cuda.synchronize()
    assert (tkern.folb_scores.launches, tkern.folb_apply.launches,
            tkern.guard_stats.launches) == (2, 2, 1)


@pytest.mark.cuda
def test_card_rejects_non_contiguous_buffers():
    dev = _card()
    _, _, g, g1 = _problem(4, 2048, torch.float32, 16, dev)
    wide = torch.zeros((4, 4096), device=dev)
    with pytest.raises(ValueError):
        tkern.folb_scores(wide[:, :2048], g1)
    with pytest.raises(ValueError):
        tkern.guard_stats(wide[:, :2048], g)
