"""Mamba2 (SSD) block (``repro.models.ssm``).

The selective state-space recurrence  h_t = a_t * h_{t-1} + dt_t B_t x_t^T,
y_t = C_t h_t + D x_t.  The full-sequence scan goes through
``kernels.ops.ssd_scan`` (the hand-written kernel on the card; on the CPU
its plain version ``ssd_chunked``, the reference's chunked form, which this
module re-exports).  Decode is the 1-step recurrence, plain PyTorch.

Shapes: heads H = d_inner / head_dim; A is a scalar decay per head
(ngroups = 1, B/C shared across heads, as in Mamba2).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import ssd_chunked  # noqa: F401
from repro_torch.models import layers

Params = Dict[str, Any]


def d_inner_of(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model


def n_ssm_heads(cfg) -> int:
    return d_inner_of(cfg) // cfg.ssm.head_dim


def init_mamba2(cfg, gen) -> Params:
    s = cfg.ssm
    d, di = cfg.d_model, d_inner_of(cfg)
    H = n_ssm_heads(cfg)
    dev = gen.device
    # fused input projection: z (gate), x, B, C, dt
    proj_out = 2 * di + 2 * s.d_state + H
    return {
        "in_proj": layers.init_linear(cfg, gen, d, proj_out),
        "out_proj": layers.init_linear(cfg, gen, di, d),
        "conv_w": layers.randn_scaled(gen, (s.d_conv, di),
                                      s.d_conv ** -0.5,
                                      layers.param_dtype(cfg)),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    s = cfg.ssm
    di = d_inner_of(cfg)
    return torch.split(zxbcdt, [di, di, s.d_state, s.d_state,
                                n_ssm_heads(cfg)], dim=-1)


def _causal_conv(cfg, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x: (B,S,di), w: (K,di)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(K))
    return F.silu(out)


def pick_chunk(S: int, target: int) -> int:
    """Largest chunk <= target that divides S (worst case 1)."""
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def _mamba2_apply(cfg, p: Params, u: torch.Tensor):
    s = cfg.ssm
    H, P = n_ssm_heads(cfg), s.head_dim
    zxbcdt = layers.apply_linear(p["in_proj"], u)
    z, x_raw, Bm, Cm, dt = _split_proj(cfg, zxbcdt)
    x = _causal_conv(cfg, p["conv_w"], x_raw)
    B_, S_, _ = x.shape
    xh = x.reshape(B_, S_, H, P).float().contiguous()
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    loga = dt * A[None, None, :]
    y, h_final = ops.ssd_scan(
        xh, loga.contiguous(), dt.contiguous(),
        Bm.float()[:, :, None, :].contiguous(),
        Cm.float()[:, :, None, :].contiguous(), pick_chunk(S_, s.chunk))
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B_, S_, H * P) * F.silu(z.float())
    out = layers.apply_linear(p["out_proj"], y.to(u.dtype))
    return out, h_final, x_raw


def mamba2_forward(cfg, p: Params, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 block. u: (B, S, d_model)."""
    return _mamba2_apply(cfg, p, u)[0]


def conv_state_of(x: torch.Tensor, K: int) -> torch.Tensor:
    """The decode conv state after a prompt x (B, S, di): its last K - 1
    rows in fp32, left-padded with zeros when S < K - 1, the state that
    token-by-token decode from a zero state reaches."""
    # the reference slices x[:, S - (K - 1):] (repro/models/ssm.py:168,
    # xlstm.py:114), which keeps only S rows when S < K - 1, so its next
    # decode step fails; the pad is the fix
    tail = x[:, max(x.shape[1] - (K - 1), 0):, :].float()
    return F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))


def mamba2_prefill(cfg, p: Params, u: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward + decode-ready state."""
    out, h_final, x_raw = _mamba2_apply(cfg, p, u)
    return out, {"ssm": h_final.float(),
                 "conv": conv_state_of(x_raw, cfg.ssm.d_conv)}


# ------------------------------------------------------------- decode

def init_mamba_state(cfg, batch: int, dtype=torch.float32,
                     device=None) -> Dict:
    s = cfg.ssm
    H, P = n_ssm_heads(cfg), s.head_dim
    return {
        "ssm": torch.zeros((batch, H, P, s.d_state), dtype=dtype,
                           device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, d_inner_of(cfg)),
                            dtype=dtype, device=device),
    }


def mamba2_decode(cfg, p: Params, u: torch.Tensor, state: Dict
                  ) -> Tuple[torch.Tensor, Dict]:
    """One-token step. u: (B, 1, d_model) -> (out (B, 1, d_model), new
    state)."""
    s = cfg.ssm
    H, P = n_ssm_heads(cfg), s.head_dim
    zxbcdt = layers.apply_linear(p["in_proj"], u[:, 0])
    z, x, Bm, Cm, dt = _split_proj(cfg, zxbcdt)
    # conv over (state || x)
    hist = torch.cat([state["conv"], x[:, None, :].to(state["conv"].dtype)],
                     dim=1)
    xc = F.silu(torch.einsum("bkd,kd->bd", hist,
                             p["conv_w"].to(hist.dtype)))
    new_conv = hist[:, 1:]

    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A[None, :])                            # (B,H)
    xh = xc.reshape(-1, H, P).float()
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm.float(), xh)
    h = state["ssm"] * decay[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), h)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(-1, H * P) * F.silu(z.float())
    out = layers.apply_linear(p["out_proj"], y.to(u.dtype)[:, None, :])
    return out, {"ssm": h, "conv": new_conv}
