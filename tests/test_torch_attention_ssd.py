"""The port's attention and SSD kernels' plain versions against the
reference's Pallas kernels run in interpret mode on the CPU.

On the CPU ``repro_torch.kernels.ops.flash_attention`` and ``ops.ssd_scan``
run their plain PyTorch versions (``kernels.ref.flash_attention_ref`` and
``kernels.ssm_scan.ssd_chunked``), so these tests hold the plain versions,
and the dispatch and validation around them, to the Pallas kernels on the
same numpy draws (bf16 inputs handed over bit for bit).  The kernels
themselves run only on the card: tests/test_torch_cuda.py compares them
with the plain versions there.

Tolerances: attention, the reference kernel test's own, 2e-5 in fp32 and
2e-2 in bf16 (one bf16 ulp of the output at unit scale).  SSD: the plain
version and the Pallas kernel both work chunk by chunk in fp32 and differ
in summation order only; y reaches about 40 over these draws and is held
to atol 2e-4 + rtol 1e-5 (SSD_ATOL, SSD_RTOL), the final state (unit
scale) to the same.  Against the sequential oracle ``ssm_scan_ref`` the
chunked form rounds in another order again; same bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ssm_scan import ssd_scan as pallas_ssd
from repro.models import ssm as rssm
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssm_scan as tssd

torch.set_num_threads(2)

FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_ATOL, SSD_RTOL = 2e-4, 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(a) -> torch.Tensor:
    """jax/numpy array -> torch tensor with the same bits (fp32 or bf16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _qkv(B, S, H, KV, d, dtype, seed):
    """The same q, k, v (numpy draws) in both packages."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, S, n, d)).astype(np.float32)
            for n in (H, KV, KV)]
    jx = [jnp.asarray(a).astype(DTYPES[dtype][0]) for a in arrs]
    return jx, [_to_torch(a) for a in jx]


def _max_err(a_torch: torch.Tensor, b_jax) -> float:
    b = np.asarray(jnp.asarray(b_jax).astype(jnp.float32))
    return float(np.abs(a_torch.float().numpy() - b).max())


# ----------------------------------------------------------- flash attention

@pytest.mark.parametrize("B,S,H,KV,d", [
    (1, 128, 2, 2, 64),      # MHA
    (2, 256, 4, 2, 64),      # GQA
    (1, 256, 4, 1, 64),      # MQA
    (2, 128, 2, 2, 128),     # wide head
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_causal_sweep_matches_pallas(B, S, H, KV, d, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(B, S, H, KV, d, dtype, B * S + H)
    want = pallas_flash(jq, jk, jv, causal=True, block_q=64, block_k=64,
                        interpret=True)
    got = tops.flash_attention(q, k, v, causal=True)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, S, H, d)
    assert _max_err(got, want) < FLASH_TOL[dtype]


@pytest.mark.parametrize("window", [64, 128, 192])
def test_flash_sliding_window_matches_pallas(window):
    (jq, jk, jv), (q, k, v) = _qkv(2, 256, 2, 2, 64, "float32", window)
    want = pallas_flash(jq, jk, jv, causal=True, sliding_window=window,
                        block_q=64, block_k=64, interpret=True)
    got = tops.flash_attention(q, k, v, causal=True, sliding_window=window)
    assert _max_err(got, want) < FLASH_TOL["float32"]


def test_flash_bidirectional_matches_pallas():
    (jq, jk, jv), (q, k, v) = _qkv(1, 128, 2, 2, 64, "float32", 7)
    want = pallas_flash(jq, jk, jv, causal=False, block_q=64, block_k=64,
                        interpret=True)
    got = tops.flash_attention(q, k, v, causal=False)
    assert _max_err(got, want) < FLASH_TOL["float32"]


@pytest.mark.parametrize("S,H,KV,d,causal,window", [
    (200, 4, 2, 80, True, 64),      # ragged S, Zamba2's head width
    (130, 2, 2, 64, False, 0),
    (77, 4, 1, 96, True, 0),
])
def test_flash_ragged_matches_reference_oracle(S, H, KV, d, causal, window):
    """Sequence lengths the Pallas kernel cannot take (not a multiple of
    its blocks): the wrapper against the reference's jnp oracle."""
    (jq, jk, jv), (q, k, v) = _qkv(2, S, H, KV, d, "float32", S)
    want = rref.flash_attention_ref(jq, jk, jv, causal=causal,
                                    sliding_window=window)
    got = tops.flash_attention(q, k, v, causal=causal,
                               sliding_window=window)
    assert _max_err(got, want) < FLASH_TOL["float32"]


def test_flash_wrapper_validates_and_counts_no_cpu_launch():
    _, (q, k, v) = _qkv(1, 16, 4, 2, 32, "float32", 0)
    tflash.flash_attention.launches = 0
    tops.flash_attention(q, k, v)
    assert tflash.flash_attention.launches == 0      # the plain version
    with pytest.raises(ValueError):
        tops.flash_attention(q, k[:, :, :1].expand(1, 16, 3, 32),
                             v[:, :, :1].expand(1, 16, 3, 32))  # 4 % 3
    with pytest.raises(ValueError):
        tops.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError):
        tops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# ------------------------------------------------------------------- SSD

def _ssd_problem(BH, S, P, N, seed):
    """Per-head inputs as the Pallas kernel takes them: x (BH, S, P),
    loga/w (BH, S), B/C (BH, S, N), as numpy fp32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BH, S, P)).astype(np.float32)
    loga = -np.logaddexp(0.0, rng.normal(size=(BH, S))).astype(np.float32)
    w = (1.0 / (1.0 + np.exp(-rng.normal(size=(BH, S))))).astype(np.float32)
    Bm = rng.normal(size=(BH, S, N)).astype(np.float32)
    Cm = rng.normal(size=(BH, S, N)).astype(np.float32)
    return x, loga, w, Bm, Cm


def _port_per_head(x, loga, w, Bm, Cm, chunk):
    """The Pallas layout through the port's entry point: B = BH, H = G = 1."""
    t = [torch.from_numpy(a) for a in (x, loga, w, Bm, Cm)]
    y, h = tops.ssd_scan(t[0][:, :, None], t[1][:, :, None],
                         t[2][:, :, None], t[3][:, :, None],
                         t[4][:, :, None], chunk=chunk)
    return y[:, :, 0], h[:, 0]


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SSD_ATOL, rtol=SSD_RTOL)


@pytest.mark.parametrize("S,P,N,chunk", [
    (64, 8, 8, 16), (128, 16, 8, 32), (256, 32, 16, 64)])
def test_ssd_sweep_matches_pallas_and_oracle(S, P, N, chunk):
    prob = _ssd_problem(2, S, P, N, S + P)
    y, h = _port_per_head(*prob, chunk)
    y_pallas = pallas_ssd(*(jnp.asarray(a) for a in prob), chunk=chunk,
                          interpret=True)
    _close(y, y_pallas)
    x, loga, w, Bm, Cm = prob
    for i in range(2):
        yr, hr = rref.ssm_scan_ref(x[i][:, None], loga[i][:, None],
                                   w[i][:, None], Bm[i], Cm[i])
        _close(y[i], yr[:, 0])
        _close(h[i], hr[0])          # the final state Pallas drops


def test_ssd_final_state_matches_reference_ssd_chunked():
    """Model layout, B/C shared by all heads (G = 1) and per head (G = H):
    y and the final state against the reference model's ssd_chunked."""
    rng = np.random.default_rng(9)
    B, S, H, P, N, chunk = 2, 96, 4, 16, 8, 32
    for G in (1, H):
        x = rng.normal(size=(B, S, H, P)).astype(np.float32)
        loga = -np.logaddexp(0.0, rng.normal(size=(B, S, H))
                             ).astype(np.float32)
        w = rng.uniform(0.1, 1.0, size=(B, S, H)).astype(np.float32)
        Bm = rng.normal(size=(B, S, G, N)).astype(np.float32)
        Cm = rng.normal(size=(B, S, G, N)).astype(np.float32)
        args = (x, loga, w, Bm, Cm)
        y_r, h_r = rssm.ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
        y, h = tops.ssd_scan(*(torch.from_numpy(a) for a in args),
                             chunk=chunk)
        assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
        _close(y, y_r)
        _close(h, h_r)


def test_ssd_chunked_init_state_matches_reference():
    rng = np.random.default_rng(4)
    B, S, H, P, N = 1, 64, 2, 8, 8
    args = [rng.normal(size=s).astype(np.float32) for s in
            ((B, S, H, P), (B, S, H), (B, S, H), (B, S, 1, N), (B, S, 1, N))]
    args[1] = -np.abs(args[1])
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    y_r, h_r = rssm.ssd_chunked(*(jnp.asarray(a) for a in args), 16,
                                init_state=jnp.asarray(h0))
    y, h = tssd.ssd_chunked(*(torch.from_numpy(a) for a in args), 16,
                            init_state=torch.from_numpy(h0))
    _close(y, y_r)
    _close(h, h_r)


@pytest.mark.parametrize("S,chunk", [(100, 25), (37, 37)])
def test_ssd_ragged_matches_sequential_oracle(S, chunk):
    """Step counts that are not a multiple of 32: the port's oracle
    ssm_scan_ref against the reference's, and the wrapper against both."""
    x, loga, w, Bm, Cm = _ssd_problem(1, S, 16, 8, S)
    yr, hr = rref.ssm_scan_ref(x[0][:, None], loga[0][:, None],
                               w[0][:, None], Bm[0], Cm[0])
    yt, ht = tref.ssm_scan_ref(*(torch.from_numpy(a) for a in (
        x[0][:, None], loga[0][:, None], w[0][:, None], Bm[0], Cm[0])))
    _close(yt, yr)
    _close(ht, hr)
    y, h = _port_per_head(x, loga, w, Bm, Cm, chunk)
    _close(y[0], yr[:, 0])
    _close(h[0], hr[0])


def test_ssd_wrapper_validates_and_counts_no_cpu_launch():
    x, loga, w, Bm, Cm = (torch.from_numpy(a) for a in
                          _ssd_problem(1, 32, 8, 8, 0))
    tssd.ssd_scan.launches = 0
    tops.ssd_scan(x[:, :, None], loga[:, :, None], w[:, :, None],
                  Bm[:, :, None], Cm[:, :, None], chunk=16)
    assert tssd.ssd_scan.launches == 0
    with pytest.raises(ValueError):       # G = 2 does not divide H = 1
        tops.ssd_scan(x[:, :, None], loga[:, :, None], w[:, :, None],
                      Bm[:, :, None].expand(1, 32, 2, 8),
                      Cm[:, :, None].expand(1, 32, 2, 8), chunk=16)
    with pytest.raises(ValueError):       # chunk does not divide S
        tops.ssd_scan(x[:, :, None], loga[:, :, None], w[:, :, None],
                      Bm[:, :, None], Cm[:, :, None], chunk=12)
    with pytest.raises(ValueError):
        tops.ssd_scan(*(t[:, :, None].to("meta")
                        for t in (x, loga, w, Bm, Cm)), chunk=16)
