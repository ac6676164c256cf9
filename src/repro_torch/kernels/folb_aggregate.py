"""Fused FOLB aggregation: ``folb_scores`` and ``folb_apply`` as CUDA
kernels written by hand for Hopper, each with its plain PyTorch version.

They replace the Pallas kernels ``folb_scores`` and ``folb_apply`` of
``repro/kernels/folb_aggregate.py``: the FOLB single-set rule over a
parameter vector of D elements and K clients in two streaming passes, one
for the K inner products <grads_k, g1> and one for w + Σ_k weight_k·Δ_k
(the normalizer between them is a sequential dependency).  The ``(K, D)``
buffers may be bf16 or fp32; every element is upcast on load and all
accumulation is fp32.  ``D`` is a multiple of ``TILE_D``.

Both passes read each buffer element once and do one multiply-add with it,
so device-memory bandwidth bounds them; the source
(``csrc/folb_aggregate.cu``) says how its design meets that.

Dispatch: a wrapper given CPU tensors runs the plain version, and only
because the tensors lie on the CPU; given CUDA tensors it launches the
kernel or raises.  Each wrapper counts its kernel launches in a plain
integer attribute (``folb_scores.launches``) so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.flat import TILE_D
from repro_torch.kernels import build

MAX_K = 3072   # the scores kernel keeps (4 warps x K) fp32 sums in 48 KB
_BUF_DTYPES = (torch.bfloat16, torch.float32)
_BLOCKS_PER_SM = 4
_sm_count = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    lib = build.load("folb_aggregate")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.folb_scores_launch.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i64,
                                       i32, ptr]
    lib.folb_scores_launch.restype = i32
    lib.folb_apply_launch.argtypes = [ptr, ptr, i32, ptr, ptr, i32, i64,
                                      i32, ptr]
    lib.folb_apply_launch.restype = i32
    return lib


def _n_blocks(device: torch.device, n_tiles: int) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return max(1, min(n_tiles, _BLOCKS_PER_SM * _sm_count[idx]))


def _check_buffer(name: str, buf: torch.Tensor) -> Tuple[int, int]:
    if buf.dim() != 2 or buf.dtype not in _BUF_DTYPES:
        raise ValueError(f"{name} must be a (K, D) bf16 or fp32 tensor, got "
                         f"{tuple(buf.shape)} {buf.dtype}")
    K, D = buf.shape
    if D % TILE_D or D == 0:
        raise ValueError(f"{name}'s D={D} is not a positive multiple of "
                         f"{TILE_D}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{name} has K={K} rows; the kernel takes 1..{MAX_K}")
    return K, D


def _check_vector(name: str, v: torch.Tensor, n: int, ref: torch.Tensor):
    if v.shape != (n,) or v.dtype != torch.float32:
        raise ValueError(f"{name} must be an fp32 ({n},) tensor, got "
                         f"{tuple(v.shape)} {v.dtype}")
    if v.device != ref.device:
        raise ValueError(f"{name} is on {v.device}, the buffer on "
                         f"{ref.device}")


def _check_launchable(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the kernel takes contiguous tensors aligned "
                             "to 16 bytes")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# ------------------------------------------------------------ folb_scores

def folb_scores_plain(grads: torch.Tensor, g1: torch.Tensor) -> torch.Tensor:
    """(K, D), (D,) -> (K,) fp32 inner products, plain PyTorch."""
    return (grads.float() * g1.float()).sum(dim=1)


def folb_scores(grads: torch.Tensor, g1: torch.Tensor) -> torch.Tensor:
    """(K, D) bf16|fp32 grads, (D,) fp32 g1 -> (K,) fp32 <grads_k, g1>."""
    K, D = _check_buffer("grads", grads)
    _check_vector("g1", g1, D, grads)
    if grads.device.type == "cpu":
        return folb_scores_plain(grads, g1)
    _check_launchable(grads, g1)
    nb = _n_blocks(grads.device, D // TILE_D)
    partial = torch.empty((K, nb), dtype=torch.float32, device=grads.device)
    out = torch.empty((K,), dtype=torch.float32, device=grads.device)
    stream = torch.cuda.current_stream(grads.device).cuda_stream
    err = _lib().folb_scores_launch(
        grads.data_ptr(), int(grads.dtype == torch.bfloat16), g1.data_ptr(),
        partial.data_ptr(), out.data_ptr(), K, D, nb, stream)
    _raise_on(err, "folb_scores")
    folb_scores.launches += 1
    return out


folb_scores.launches = 0


# ------------------------------------------------------------- folb_apply

def folb_apply_plain(w: torch.Tensor, deltas: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """(D,), (K, D), (K,) -> (D,) w + Σ_k weights_k·Δ_k, plain PyTorch."""
    upd = (weights.float()[:, None] * deltas.float()).sum(dim=0)
    return (w.float() + upd).to(w.dtype)


def folb_apply(w: torch.Tensor, deltas: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """(D,) fp32 w, (K, D) bf16|fp32 deltas, (K,) fp32 weights -> (D,) fp32
    w + Σ_k weights_k·Δ_k, added in fp32."""
    K, D = _check_buffer("deltas", deltas)
    _check_vector("w", w, D, deltas)
    _check_vector("weights", weights, K, deltas)
    if deltas.device.type == "cpu":
        return folb_apply_plain(w, deltas, weights)
    _check_launchable(w, deltas, weights)
    nb = _n_blocks(deltas.device, D // TILE_D)
    out = torch.empty((D,), dtype=torch.float32, device=deltas.device)
    stream = torch.cuda.current_stream(deltas.device).cuda_stream
    err = _lib().folb_apply_launch(
        w.data_ptr(), deltas.data_ptr(), int(deltas.dtype == torch.bfloat16),
        weights.data_ptr(), out.data_ptr(), K, D, nb, stream)
    _raise_on(err, "folb_apply")
    folb_apply.launches += 1
    return out


folb_apply.launches = 0


def reset_launches() -> None:
    folb_scores.launches = 0
    folb_apply.launches = 0


def folb_aggregate(w: torch.Tensor, deltas: torch.Tensor,
                   grads: torch.Tensor, g1: torch.Tensor,
                   psi_gamma: torch.Tensor, g1_sq: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused FOLB aggregation; matches ``kernels.ref.folb_aggregate_ref``:
    scores = <grads_k, g1> − ψγ_k·||g1||², normalized by Σ|scores| clamped
    at 1e-30, then w + Σ_k (scores_k / Σ|scores|)·Δ_k."""
    inner = folb_scores(grads, g1)
    scores = inner - psi_gamma.float() * g1_sq.float()
    denom = torch.clamp(scores.abs().sum(), min=1e-30)
    new_w = folb_apply(w, deltas, scores / denom)
    return new_w, scores
