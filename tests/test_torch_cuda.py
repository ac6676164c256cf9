"""The port's hand-written kernels on the card: each against its plain
PyTorch version on the same CUDA tensors (``guard_stats`` also on inputs
with NaN and ±Inf planted), the launch counters, and reduced Zamba2 and
xLSTM prefill + decode on the card against the port's CPU path.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither jax nor the JAX package, so it also runs on a machine
that has only PyTorch (``--noconftest`` skips the suite's JAX fixtures):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerance: rtol 1e-5 / atol 1e-6 for the FOLB kernels, as in
chip_smoke.py; kernel and plain version sum the same fp32 products in
another order.  ``guard_stats``'s finite flags must match exactly.
``flash_attention``: 2e-5 in fp32, 2e-2 in bf16 (the reference's own
kernel-test bounds).  ``ssd_scan``: the kernel runs the recurrence step by
step, the plain version chunk by chunk; over up to 512 steps of unit-scale
inputs they differ by fp32 rounding, held to atol 2e-4 + rtol 1e-4 on y and
the final state (SSD_ATOL/SSD_RTOL).  ``slstm_scan``: kernel and plain
version run the same fp32 recurrence, summing each step's products in
another order; out (|h| <= 1) and the final (h, c, n) within 1e-4 in fp32,
and out within two bf16 ulps at unit scale (2^-7) in bf16, where one
rounding of h can land on either side (SLSTM_TOL).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import folb_aggregate as tkern
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slstm_scan as tslstm
from repro_torch.kernels import ssm_scan as tssd
from repro_torch.kernels.guard import GuardConfig

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_ATOL, SSD_RTOL = 2e-4, 1e-4
SLSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
MODEL_ATOL = 1e-4
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


# (B, S, H, KV, d, causal, window, dtype): the Zamba2 and fed100m prefill
# heads, GQA + window, MQA, a ragged S, non-causal, the widest head
FLASH_CASES = [
    (2, 512, 8, 8, 80, True, 0, torch.bfloat16),
    (2, 512, 12, 12, 64, True, 0, torch.float32),
    (1, 1024, 8, 2, 128, True, 256, torch.float32),
    (2, 256, 4, 1, 64, True, 0, torch.bfloat16),
    (2, 200, 4, 2, 80, True, 64, torch.float32),
    (1, 130, 2, 2, 64, False, 0, torch.float32),
    (1, 256, 2, 2, 256, True, 0, torch.bfloat16),
    (1, 96, 4, 4, 96, False, 48, torch.float32),
]


def _qkv(B, S, H, KV, d, dtype, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, S, H, d), generator=gen)
    k = torch.randn((B, S, KV, d), generator=gen)
    v = torch.randn((B, S, KV, d), generator=gen)
    return (t.to(dev, dtype) for t in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,d,causal,window,dtype", FLASH_CASES)
def test_flash_attention_matches_plain_on_card(B, S, H, KV, d, causal,
                                               window, dtype):
    dev = _card()
    q, k, v = _qkv(B, S, H, KV, d, dtype, S + d, dev)
    tflash.flash_attention.launches = 0
    out = tflash.flash_attention(q, k, v, causal=causal,
                                 sliding_window=window)
    want = tref.flash_attention_ref(q, k, v, causal=causal,
                                    sliding_window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and tflash.flash_attention.launches == 1
    err = float((out.float() - want.float()).abs().max())
    assert err < FLASH_TOL[dtype], err


@pytest.mark.cuda
def test_flash_attention_reads_strided_inputs():
    """q/k/v as views into one fused (B, S, 3, H, d) projection."""
    dev = _card()
    gen = torch.Generator().manual_seed(5)
    qkv = torch.randn((2, 160, 3, 4, 64), generator=gen).to(dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    out = tflash.flash_attention(q, k, v, causal=True)
    want = tref.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) < FLASH_TOL[torch.float32]


def _ssd_inputs(B, S, H, P, G, N, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=gen)
    loga = -torch.nn.functional.softplus(torch.randn((B, S, H),
                                                     generator=gen))
    w = torch.sigmoid(torch.randn((B, S, H), generator=gen))
    Bm = torch.randn((B, S, G, N), generator=gen)
    Cm = torch.randn((B, S, G, N), generator=gen)
    return tuple(t.to(dev) for t in (x, loga, w, Bm, Cm))


# (B, S, H, P, G, N, chunk): Zamba2 at full width (cut to B = 1), the
# reduced model, per-head groups as the Pallas kernel takes them, S = chunk,
# a step count that is not a multiple of the kernel's staging tile, and the
# largest state (N = 128) at P = 64, 384 and 1024 (rows over 1, 2 and 4
# blocks)
SSD_CASES = [
    (1, 512, 80, 64, 1, 64, 256),
    (2, 64, 16, 32, 1, 16, 32),
    (4, 128, 1, 16, 1, 8, 32),
    (2, 256, 4, 64, 1, 64, 256),
    (2, 100, 3, 24, 3, 32, 50),
    (2, 128, 4, 64, 1, 128, 64),
    (2, 128, 4, 384, 1, 128, 64),
    (1, 128, 2, 1024, 1, 128, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_CASES)
def test_ssd_scan_matches_plain_on_card(B, S, H, P, G, N, chunk):
    dev = _card()
    args = _ssd_inputs(B, S, H, P, G, N, S + P + N, dev)
    tssd.ssd_scan.launches = 0
    y, h = tssd.ssd_scan(*args, chunk=chunk)
    y_p, h_p = tssd.ssd_chunked(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert tssd.ssd_scan.launches == 1
    torch.testing.assert_close(y, y_p, atol=SSD_ATOL, rtol=SSD_RTOL)
    torch.testing.assert_close(h, h_p, atol=SSD_ATOL, rtol=SSD_RTOL)


# (B, S, H, dh, dtype): xLSTM-1.3B's sLSTM at full width, in bf16 and
# fp32; a prime S at full width; the reduced model
SLSTM_CASES = [
    (4, 512, 4, 512, torch.bfloat16),
    (4, 512, 4, 512, torch.float32),
    (2, 127, 4, 512, torch.float32),
    (2, 37, 4, 64, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,dh,dtype", SLSTM_CASES)
def test_slstm_scan_matches_plain_on_card(B, S, H, dh, dtype):
    dev = _card()
    gen = torch.Generator().manual_seed(S + dh)
    xg = torch.randn((B, S, 4 * H * dh), generator=gen).to(dev, dtype)
    r = (torch.randn((H, dh, 4 * dh), generator=gen) * dh ** -0.5).to(
        dev, dtype)
    tslstm.slstm_scan.launches = 0
    out, state = tslstm.slstm_scan(xg, r, H)
    want, want_state = tref.slstm_scan_ref(xg, r, H)
    torch.cuda.synchronize()
    assert tslstm.slstm_scan.launches == 1 and out.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(),
                               atol=SLSTM_TOL[dtype], rtol=0)
    for got, ref in zip(state, want_state):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


def _card_vs_cpu(arch, n_layers, want_prefill):
    """Reduced ``arch`` in fp32: the card's prefill of 40 tokens and 3
    decode steps against the port's CPU path from the same weights; the
    prefill launches ``want_prefill`` (the others: none), decode none."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    dev = _card()
    cfg = get_config(arch).reduced(n_layers=n_layers)
    gen = torch.Generator().manual_seed(0)
    cpu_params = model.init_params(cfg, gen)
    card_params = _to(cpu_params, dev)
    toks = torch.randint(0, cfg.vocab, (2, 43), generator=gen)
    outs = {}
    for name, params, d in (("cpu", cpu_params, "cpu"),
                            ("card", card_params, dev)):
        tops.reset_launches()
        with torch.inference_mode():
            lg, cache = model.prefill(cfg, params,
                                      {"tokens": toks[:, :40].to(d)},
                                      cache_len=43)
            seq = [lg]
            counts = tops.launches()
            for i in range(40, 43):
                lg, cache = model.decode_step(cfg, params, cache,
                                              toks[:, i:i + 1].to(d))
                seq.append(lg)
        outs[name] = torch.stack(seq).cpu()
        if name == "card":
            torch.cuda.synchronize()
            assert counts == {k: want_prefill.get(k, 0) for k in counts}
            assert tops.launches() == counts
    torch.testing.assert_close(outs["card"], outs["cpu"], atol=MODEL_ATOL,
                               rtol=0)


@pytest.mark.cuda
def test_reduced_xlstm_prefill_decode_card_vs_cpu():
    """Two super-groups: one sLSTM scan per group in prefill; the mLSTM
    recurrence is plain, so no ``ssd_scan``."""
    _card_vs_cpu("xlstm-1.3b", 4, {"slstm_scan": 2})


@pytest.mark.cuda
def test_reduced_zamba2_prefill_decode_card_vs_cpu():
    """Two super-groups: 2 flash and 4 scan launches in prefill."""
    _card_vs_cpu("zamba2-2.7b", 4, {"flash_attention": 2, "ssd_scan": 4})


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
def test_profile_serve_sees_the_kernels_on_card(capsys):
    """The profiler script's breakdown counts the attention kernel and
    reports a device busy share in (0, 1]."""
    _card()
    from repro_torch.launch import profile_serve
    out = profile_serve.main(["--arch", "fed100m"])
    for phase in ("prefill", "decode"):
        row = out[phase]
        assert 0.0 < row["device_busy_share"] <= 1.0
        assert row["n_kernel_launches"] > 0
    assert any("flash_kernel" in t["kernel"] for t in out["prefill"]["top"])
    assert capsys.readouterr().out.count("\n") == 2
