"""The sLSTM recurrence (xLSTM's scalar memory): a CUDA kernel written by
hand for Hopper (``csrc/slstm_scan.cu``) beside its plain PyTorch version
(``kernels.ref.slstm_scan_ref``).

Per (batch, head), from h = c = n = 0:

    g_t = xg_t + h_{t-1} @ r_h      (gate columns [z, i, f, o] x dh)
    c_t = σ(f) c + σ(i) tanh(z);  n_t = σ(f) n + σ(i);
    h_t = σ(o) c_t / max(n_t, 1e-6)

It replaces the Pallas kernel ``repro/kernels/slstm_scan.py``, takes any
sequence length (the Pallas kernel needs multiples of its 256-step chunk)
and also returns the final (h, c, n), which the model's prefill hands to
decode.  xg ``(B, S, 4d)``, its 4d axis ``[z, i, f, o] x (H, dh)``, and r
``(H, dh, 4dh)``, each bf16 or fp32; out ``(B, S, d)`` in xg's dtype;
state and products in fp32.  The source says what bounds the kernel and
how its design meets that.

Dispatch: given CPU tensors the wrapper runs the plain version, and only
because the tensors lie on the CPU; given CUDA tensors it launches the
kernel or raises.  ``slstm_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import slstm_scan_ref

MAX_HEAD_DIM = 1024      # dh: one lane per thread of a 1024-thread block
_DTYPES = (torch.bfloat16, torch.float32)

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature."""
    lib = build.load("slstm_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.slstm_scan_launch.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.slstm_scan_launch.restype = i32
    return lib


def _check(xg: torch.Tensor, r: torch.Tensor, n_heads: int) -> None:
    if xg.dim() != 3 or r.dim() != 3:
        raise ValueError(f"xg must be (B, S, 4d) and r (H, dh, 4dh), got "
                         f"{tuple(xg.shape)}, {tuple(r.shape)}")
    H, dh = r.shape[0], r.shape[1]
    if H != n_heads or r.shape[2] != 4 * dh or xg.shape[2] != 4 * H * dh:
        raise ValueError(f"xg {tuple(xg.shape)} and r {tuple(r.shape)} do "
                         f"not fit {n_heads} heads")
    if xg.dtype not in _DTYPES or r.dtype not in _DTYPES:
        raise ValueError(f"xg and r must be bf16 or fp32, got {xg.dtype}, "
                         f"{r.dtype}")
    if xg.device != r.device:
        raise ValueError(f"xg and r lie on {xg.device}, {r.device}")


def slstm_scan(xg: torch.Tensor, r: torch.Tensor, n_heads: int
               ) -> Tuple[torch.Tensor, State]:
    """sLSTM over the sequence -> (out (B, S, d) in xg's dtype, final
    (h, c, n) each (B, d) fp32)."""
    _check(xg, r, n_heads)
    if xg.device.type == "cpu":
        return slstm_scan_ref(xg, r, n_heads)
    if xg.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {xg.device}")
    B, S, d4 = xg.shape
    H, dh = r.shape[0], r.shape[1]
    if dh > MAX_HEAD_DIM or (4 * dh * r.element_size()) % 16:
        raise ValueError(f"the kernel takes dh <= {MAX_HEAD_DIM} with 4 dh "
                         f"a multiple of 16 bytes of r, got dh = {dh}, "
                         f"{r.dtype}")
    for name, t in (("xg", xg), ("r", r)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the kernel takes contiguous, 16-byte aligned "
                             f"inputs; {name} is not")
    out = torch.empty((B, S, d4 // 4), dtype=xg.dtype, device=xg.device)
    h, c, n = (torch.empty((B, d4 // 4), dtype=torch.float32,
                           device=xg.device) for _ in range(3))
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    err = _lib().slstm_scan_launch(
        xg.data_ptr(), r.data_ptr(), out.data_ptr(), h.data_ptr(),
        c.data_ptr(), n.data_ptr(), int(xg.dtype == torch.bfloat16),
        int(r.dtype == torch.bfloat16), B, S, H, dh, stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    slstm_scan.launches += 1
    return out, (h, c, n)


slstm_scan.launches = 0
