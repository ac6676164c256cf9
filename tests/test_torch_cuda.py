"""The port's hand-written kernels on the card: each against its plain
PyTorch version on the same CUDA tensors, and the launch counters.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither jax nor the JAX package, so it also runs on a machine
that has only PyTorch (``--noconftest`` skips the suite's JAX fixtures):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerance: rtol 1e-5 / atol 1e-6, as in chip_smoke.py; kernel and plain
version sum the same fp32 products in another order.
"""
import pytest
import torch

from repro_torch.kernels import folb_aggregate as tkern
from repro_torch.kernels import ops as tops

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


@pytest.mark.cuda
def test_card_launches_are_counted():
    dev = _card()
    w, d, g, _ = _problem(4, 2048, torch.bfloat16, 15, dev)
    tkern.reset_launches()
    tops.folb_aggregate_buffers(w, d, g)
    torch.cuda.synchronize()
    assert (tkern.folb_scores.launches, tkern.folb_apply.launches) == (1, 1)


@pytest.mark.cuda
def test_card_rejects_non_contiguous_buffers():
    dev = _card()
    _, _, g, g1 = _problem(4, 2048, torch.float32, 16, dev)
    wide = torch.zeros((4, 4096), device=dev)
    with pytest.raises(ValueError):
        tkern.folb_scores(wide[:, :2048], g1)
