"""Flash attention: a CUDA kernel written by hand for Hopper
(``csrc/flash_attention.cu``) beside its plain PyTorch version
(``kernels.ref.flash_attention_ref``).

It replaces the Pallas kernel ``repro/kernels/flash_attention.py``:
online-softmax attention, causal and/or sliding window, GQA, fp32 softmax
state, masked scores -1e30, output acc / max(l, 1e-30) in q's dtype.  The
kernel takes any sequence lengths (the Pallas kernel needs multiples of its
128-row blocks) and reads q, k and v in the model's ``(B, S, heads, d)``
layout through their strides.  The source says what bounds it and how its
design meets that.

Dispatch: given CPU tensors the wrapper runs the plain version, and only
because the tensors lie on the CPU; given CUDA tensors it launches the
kernel or raises.  ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

MAX_HEAD_DIM = 256
_DTYPES = (torch.bfloat16, torch.float32)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature."""
    lib = build.load("flash_attention")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [ptr, ptr, ptr, ptr, i32] + [i64] * 9
        + [i32] * 8 + [ctypes.c_float, ptr])
    lib.flash_attention_launch.restype = i32
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Sq, H, d) and k, v (B, Sk, KV, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a bf16 or fp32 dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, "
                         f"{v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sliding_window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, d); k/v: (B, Sk, KV, d), H % KV == 0, one dtype (bf16
    or fp32).  Returns (B, Sq, H, d) in q's dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {q.device}")
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the kernel needs the head dim contiguous")
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        B, Sq, Sk, H, KV, d, int(causal), int(sliding_window),
        d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
