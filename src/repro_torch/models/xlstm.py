"""xLSTM blocks (``repro.models.xlstm``): mLSTM (matrix memory, chunked
gated linear attention) and sLSTM (scalar memory, sequential recurrence)
[arXiv:2405.04517].

mLSTM: per-head keys and queries (G = H), state C_t = f_t C_{t-1} + i_t v_t
k_tᵀ and normaliser n_t = f_t n_{t-1} + i_t k_t, the normaliser computed by
augmenting the value dim with a ones channel (P = dh + 1).  The input gate
is a sigmoid, as in the reference.  The full-sequence recurrence calls the
plain ``ssd_chunked`` directly, never ``ops.ssd_scan``: at xLSTM-1.3B it
runs at N = dh = 1024 and P = 1025, outside the ``ssd_scan`` kernel's
shapes, and the reference too computes it outside any Pallas kernel
(``repro/models/xlstm.py:97``).

sLSTM: the recurrence over the sequence goes through ``ops.slstm_scan``
(the hand-written kernel on the card, its plain version on the CPU), which
also returns the final (h, c, n) for decode.  The reference's model scans
``_slstm_cell`` instead of calling its Pallas kernel; both compute the
same function.  Decode is one ``_slstm_cell`` step.

Dtypes follow the reference: states in fp32, gates summed in fp32 over
inputs in the compute dtype; a product of fp32 activations with bf16
weights promotes to fp32, as JAX does.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import slstm_cell
from repro_torch.kernels.ssm_scan import ssd_chunked
from repro_torch.models import layers, ssm

Params = Dict[str, Any]


def d_inner_of(cfg) -> int:
    return int(cfg.xlstm.proj_factor * cfg.d_model)


def _promote(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their promoted dtype (JAX's rule for fp32 with
    bf16)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _blockdiag(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-head projection: t (..., H, dh) by w (H, dh, dh)."""
    t, w = _promote(t, w)
    return torch.einsum("...hd,hdk->...hk", t, w)


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``layers.apply_linear`` with the operands promoted."""
    x, w = _promote(x, p["w"])
    return x @ w


# ------------------------------------------------------------- mLSTM

def init_mlstm(cfg, gen) -> Params:
    d, di, H = cfg.d_model, d_inner_of(cfg), cfg.n_heads
    dh = di // H
    dt = layers.param_dtype(cfg)
    K = cfg.xlstm.conv_kernel

    def blockdiag():
        # per-head (block-diagonal) projection, as in xLSTM-1.3b
        return layers.randn_scaled(gen, (H, dh, dh), dh ** -0.5, dt)

    return {
        "up": layers.init_linear(cfg, gen, d, 2 * di),   # u (cell) + z (gate)
        "conv_w": layers.randn_scaled(gen, (K, di), K ** -0.5, dt),
        "wq": blockdiag(),
        "wk": blockdiag(),
        "wv": blockdiag(),
        "w_gates": layers.init_linear(cfg, gen, di, 2 * H),
        "down": layers.init_linear(cfg, gen, di, d),
        "gate_bias": torch.cat([torch.zeros((H,)), 3.0 * torch.ones((H,))]
                               ).to(gen.device),
    }


def _causal_conv(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + SiLU, the same as Mamba2's."""
    return ssm._causal_conv(None, w, x)


def _mlstm_qkv_gates(cfg, p: Params, u: torch.Tensor, conv_fn):
    """u: (B, S, di) cell-path input (pre-conv) -> q, k, v, log f, i."""
    H = cfg.n_heads
    B_, S_, di = u.shape
    dh = di // H
    uc = conv_fn(u)
    q = _blockdiag(p["wq"], uc.reshape(B_, S_, H, dh))
    k = _blockdiag(p["wk"], uc.reshape(B_, S_, H, dh)) * dh ** -0.5
    v = _blockdiag(p["wv"], u.reshape(B_, S_, H, dh))
    gates = _linear(p["w_gates"], uc).float() + p["gate_bias"]
    ig, fg = torch.chunk(gates, 2, dim=-1)                      # (B,S,H)
    return q, k, v, F.logsigmoid(fg), torch.sigmoid(ig)


def _normalise(y_aug: torch.Tensor, dh: int) -> torch.Tensor:
    """Value channels over max(|normaliser channel|, 1)."""
    y, denom = y_aug[..., :dh], y_aug[..., dh]
    return y / torch.clamp(denom.abs(), min=1.0)[..., None]


def _mlstm_apply(cfg, p: Params, x: torch.Tensor):
    di = d_inner_of(cfg)
    u, z = torch.split(layers.apply_linear(p["up"], x), [di, di], dim=-1)
    q, k, v, log_f, i_in = _mlstm_qkv_gates(
        cfg, p, u, lambda t: _causal_conv(p["conv_w"], t))
    B_, S_, H, dh = v.shape
    # augment the value dim with ones: the last channel computes q . n_t
    v_aug = torch.cat([v.float(), torch.ones((B_, S_, H, 1),
                                             device=v.device)], dim=-1)
    # plain on purpose: (N, P) = (dh, dh + 1) is outside ssd_scan's shapes
    y_aug, C_final = ssd_chunked(v_aug, log_f, i_in, k.float(), q.float(),
                                 ssm.pick_chunk(S_, cfg.xlstm.chunk))
    y = _normalise(y_aug, dh).reshape(B_, S_, di) * F.silu(z.float())
    return layers.apply_linear(p["down"], y.to(x.dtype)), C_final, u


def mlstm_forward(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence mLSTM block body (residual handled by caller)."""
    return _mlstm_apply(cfg, p, x)[0]


def mlstm_prefill(cfg, p: Params, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict]:
    out, C_final, u = _mlstm_apply(cfg, p, x)
    return out, {"C": C_final.float(),
                 "conv": ssm.conv_state_of(u, cfg.xlstm.conv_kernel)}


def init_mlstm_state(cfg, batch: int, dtype=torch.float32,
                     device=None) -> Dict:
    di = d_inner_of(cfg)
    dh = di // cfg.n_heads
    return {
        # + 1 = the normaliser row
        "C": torch.zeros((batch, cfg.n_heads, dh + 1, dh), dtype=dtype,
                         device=device),
        "conv": torch.zeros((batch, cfg.xlstm.conv_kernel - 1, di),
                            dtype=dtype, device=device),
    }


def mlstm_decode(cfg, p: Params, x: torch.Tensor, state: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
    """One-token step. x: (B, 1, d) -> (out (B, 1, d), new state)."""
    di = d_inner_of(cfg)
    H = cfg.n_heads
    dh = di // H
    B_ = x.shape[0]
    u, z = torch.split(layers.apply_linear(p["up"], x[:, 0]), [di, di],
                       dim=-1)
    hist = torch.cat([state["conv"], u[:, None, :].to(state["conv"].dtype)],
                     dim=1)
    uc = F.silu(torch.einsum("bkd,kd->bd", hist,
                             p["conv_w"].to(hist.dtype)))
    q = _blockdiag(p["wq"], uc.reshape(B_, H, dh))
    k = _blockdiag(p["wk"], uc.reshape(B_, H, dh)) * dh ** -0.5
    v = _blockdiag(p["wv"], u.reshape(B_, H, dh))
    gates = _linear(p["w_gates"], uc).float() + p["gate_bias"]
    ig, fg = torch.chunk(gates, 2, dim=-1)
    f, i_in = torch.sigmoid(fg), torch.sigmoid(ig)
    v_aug = torch.cat([v.float(), torch.ones((B_, H, 1), device=v.device)],
                      dim=-1)
    C = state["C"] * f[..., None, None] + i_in[..., None, None] * \
        torch.einsum("bhp,bhn->bhpn", v_aug, k.float())
    y_aug = torch.einsum("bhpn,bhn->bhp", C, q.float())
    y = _normalise(y_aug, dh).reshape(B_, di) * F.silu(z.float())
    out = layers.apply_linear(p["down"], y.to(x.dtype)[:, None, :])
    return out, {"C": C, "conv": hist[:, 1:]}


# ------------------------------------------------------------- sLSTM

def init_slstm(cfg, gen) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    return {
        "wx": layers.init_linear(cfg, gen, d, 4 * d),
        "r": layers.randn_scaled(gen, (H, dh, 4 * dh), dh ** -0.5,
                                 layers.param_dtype(cfg)),
        "ffn": layers.init_mlp(cfg, gen, d, 2 * d),
        "ffn_norm": layers.init_norm(cfg, gen, d),
    }


def _slstm_cell(cfg, p: Params, xg, h, c, n):
    """xg: (B, 4d) precomputed input part; h/c/n: (B, d) fp32."""
    return slstm_cell(xg, p["r"], h, c, n)


def _post_cell(cfg, p: Params, y: torch.Tensor) -> torch.Tensor:
    """The block's small GLU FFN after the cell (its up/down projection)."""
    return y + layers.apply_mlp(cfg, p["ffn"],
                                layers.apply_norm(cfg, p["ffn_norm"], y))


def _slstm_apply(cfg, p: Params, x: torch.Tensor):
    xg = layers.apply_linear(p["wx"], x)                          # (B,S,4d)
    hs, (h, c, n) = ops.slstm_scan(xg, p["r"], cfg.n_heads)
    return _post_cell(cfg, p, hs.to(x.dtype)), {"h": h, "c": c, "n": n}


def slstm_forward(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence sLSTM block body. x: (B, S, d)."""
    return _slstm_apply(cfg, p, x)[0]


def slstm_prefill(cfg, p: Params, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict]:
    return _slstm_apply(cfg, p, x)


def init_slstm_state(cfg, batch: int, dtype=torch.float32,
                     device=None) -> Dict:
    return {name: torch.zeros((batch, cfg.d_model), dtype=dtype,
                              device=device) for name in ("h", "c", "n")}


def slstm_decode(cfg, p: Params, x: torch.Tensor, state: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
    """One-token step. x: (B, 1, d) -> (out (B, 1, d), new state)."""
    xg = layers.apply_linear(p["wx"], x[:, 0])
    h, c, n = _slstm_cell(cfg, p, xg, state["h"].float(),
                          state["c"].float(), state["n"].float())
    return _post_cell(cfg, p, h.to(x.dtype)[:, None, :]), \
        {"h": h, "c": c, "n": n}
