"""Fused FOLB aggregation: ``folb_scores``, ``folb_apply`` and
``guard_stats`` as CUDA kernels written by hand for Hopper, each with its
plain PyTorch version, and the tensor algebra around them.

They replace the Pallas kernels of ``repro/kernels/folb_aggregate.py``: the
FOLB single-set rule over a parameter vector of D elements and K clients in
two streaming passes, one for the K inner products <grads_k, g1> and one
for w + Σ_k weight_k·Δ_k (the normalizer between them is a sequential
dependency), and, on the guarded path, a third pass ahead of them for the
per-row delta norms and finite flags.  The ``(K, D)`` buffers may be bf16
or fp32; every element is upcast on load and all accumulation is fp32.
``D`` is a multiple of ``TILE_D``.

Each pass reads each buffer element once and does one multiply-add with
it, so device-memory bandwidth bounds them; the source
(``csrc/folb_aggregate.cu``) says how its design meets that.

Around the kernels, as in the reference, plain tensor code computes the
masked g1, ||g1||², the scrub of non-finite lanes and the guard's K-sized
algebra (masked medians, gating, clipping, counters): ``folb_aggregate``,
``folb_aggregate_stale`` and ``folb_aggregate_stale_guarded``.

Dispatch: a wrapper given CPU tensors runs the plain version, and only
because the tensors lie on the CPU; given CUDA tensors it launches the
kernel or raises.  Each wrapper counts its kernel launches in a plain
integer attribute (``folb_scores.launches``) so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import math
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
    lib.guard_stats_launch.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, ptr,
                                       i32, i64, i32, ptr]
    lib.guard_stats_launch.restype = i32
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


# ------------------------------------------------------------ guard_stats

def guard_stats_plain(deltas: torch.Tensor, grads: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, D), (K, D) -> ((K,) Σ where(finite(Δ), Δ, 0)², (K,) finite
    flags), plain PyTorch."""
    d, g = deltas.float(), grads.float()
    fin_d = torch.isfinite(d)
    finite = (fin_d.all(dim=1) & torch.isfinite(g).all(dim=1)).float()
    d0 = torch.where(fin_d, d, 0.0)
    return (d0 * d0).sum(dim=1), finite


def guard_stats(deltas: torch.Tensor, grads: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, D) bf16|fp32 deltas and grads of one dtype -> ((K,) fp32 delta
    sqnorms with non-finite lanes zeroed before squaring, (K,) fp32 flags,
    1.0 iff every delta and grad lane of the row is finite)."""
    K, D = _check_buffer("deltas", deltas)
    if grads.shape != deltas.shape or grads.dtype != deltas.dtype:
        raise ValueError(f"grads must match deltas {tuple(deltas.shape)} "
                         f"{deltas.dtype}, got {tuple(grads.shape)} "
                         f"{grads.dtype}")
    if grads.device != deltas.device:
        raise ValueError(f"grads are on {grads.device}, deltas on "
                         f"{deltas.device}")
    if deltas.device.type == "cpu":
        return guard_stats_plain(deltas, grads)
    _check_launchable(deltas, grads)
    dev = deltas.device
    nb = _n_blocks(dev, D // TILE_D)
    norm_part = torch.empty((K, nb), dtype=torch.float32, device=dev)
    bad_part = torch.empty((K, nb), dtype=torch.int32, device=dev)
    norms_sq = torch.empty((K,), dtype=torch.float32, device=dev)
    finite = torch.empty((K,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().guard_stats_launch(
        deltas.data_ptr(), grads.data_ptr(),
        int(deltas.dtype == torch.bfloat16), norm_part.data_ptr(),
        bad_part.data_ptr(), norms_sq.data_ptr(), finite.data_ptr(), K, D,
        nb, stream)
    _raise_on(err, "guard_stats")
    guard_stats.launches += 1
    return norms_sq, finite


guard_stats.launches = 0


def reset_launches() -> None:
    folb_scores.launches = 0
    folb_apply.launches = 0
    guard_stats.launches = 0


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


def folb_aggregate_stale(w: torch.Tensor, deltas: torch.Tensor,
                         grads: torch.Tensor, tau: torch.Tensor, alpha,
                         psi_gamma: torch.Tensor, mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Staleness-discounted FOLB over the masked (arrived) rows; matches
    ``kernels.ref.folb_aggregate_stale_ref``:
        I_k = (<g_k, g1> − ψγ_k ||g1||²) · (1 + τ_k)^{−α} · m_k
    with g1 the masked mean of the grads.  The same two kernel passes as
    ``folb_aggregate``; a masked row enters every sum as an exact 0.0·x."""
    m = mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    g1 = torch.tensordot(m, grads.float(), dims=1) / n
    g1_sq = (g1 * g1).sum()
    inner = folb_scores(grads, g1)
    scores = inner - psi_gamma.float() * g1_sq
    scores = scores * torch.pow(1.0 + tau.float(), -alpha) * m
    denom = torch.clamp(scores.abs().sum(), min=1e-30)
    new_w = folb_apply(w, deltas, scores / denom)
    return new_w, scores


# ------------------------------------------------------------ guarded path

def masked_median(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Median of ``x`` over entries with ``m > 0`` (midpoint of the two
    central order statistics); 0.0 on an empty set.  ``x`` must be finite
    and non-negative where masked in (|scores|, norms)."""
    K = x.shape[0]
    s = torch.sort(torch.where(m > 0.0, x, math.inf)).values
    n = (m > 0.0).sum()
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, K - 1)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, K - 1)
    # gather, not s[lo]: indexing by a device scalar would wait for it
    mid = s.gather(0, torch.stack([lo, hi]))
    med = 0.5 * (mid[0] + mid[1])
    return torch.where(n > 0, med, 0.0)


def _guard_algebra(inner, g1_sq, norms_sq, finite, m_in, tau, alpha,
                   psi_gamma, guard):
    """The guard's K-sized algebra after the stats pass: scores, score
    gating and norm clipping against masked medians, rejection counters.
    Returns (weights, scores, m0, n_nonfinite, n_clipped, n_gated);
    ``guard`` is static, so a disabled defence does no work."""
    fin = finite if guard.nonfinite else torch.ones_like(finite)
    m0 = m_in * fin
    scores = inner - psi_gamma.float() * g1_sq
    scores = scores * torch.pow(1.0 + tau.float(), -alpha) * m0
    n_nonfinite = (m_in * (1.0 - finite)).sum()
    n_gated = torch.zeros((), dtype=torch.float32, device=inner.device)
    if guard.gate_mult > 0.0:
        med = masked_median(scores.abs(), m0)
        keep = (scores.abs() <= guard.gate_mult * med).float()
        # a zero median means no meaningful score spread to trim against
        keep = torch.where(med > 0.0, keep, torch.ones_like(keep))
        n_gated = (m0 * (1.0 - keep)).sum()
        m0 = m0 * keep
        scores = scores * keep
    clipf = torch.ones_like(m0)
    n_clipped = torch.zeros((), dtype=torch.float32, device=inner.device)
    if guard.clip_mult > 0.0:
        norms = torch.sqrt(norms_sq)
        thresh = guard.clip_mult * masked_median(norms, m0)
        do_clip = (norms > thresh) & (thresh > 0.0)
        clipf = torch.where(do_clip, thresh / torch.clamp(norms, min=1e-30),
                            torch.ones_like(norms))
        n_clipped = (m0 * do_clip.float()).sum()
    denom = torch.clamp(scores.abs().sum(), min=1e-30)
    weights = scores / denom * clipf
    return weights, scores, m0, n_nonfinite, n_clipped, n_gated


def _scrub(x: torch.Tensor) -> torch.Tensor:
    """Zero non-finite lanes so no downstream reduction sees them (0·NaN
    would break the masked-row exact-cancellation contract).  Elementwise:
    whole-row rejection is the mask's job."""
    return torch.where(torch.isfinite(x), x, 0.0)


def folb_aggregate_stale_guarded(w: torch.Tensor, deltas: torch.Tensor,
                                 grads: torch.Tensor, tau: torch.Tensor,
                                 alpha, psi_gamma: torch.Tensor,
                                 mask: torch.Tensor, guard):
    """``folb_aggregate_stale`` with the defences of ``kernels.guard.
    GuardConfig`` (static): one ``guard_stats`` pass ahead of the two
    aggregation passes; rejected rows leave the mask like masked ones, and
    an all-rejected aggregation returns ``w`` bit-exact.  Returns
    ``(new_w, scores, ginfo)``, ginfo = {mask (post-guard), n_nonfinite,
    n_clipped, n_gated}; matches ``kernels.guard.reference_guard``."""
    m_in = mask.float()
    norms_sq, finite = guard_stats(deltas, grads)
    fin = finite if guard.nonfinite else torch.ones_like(finite)
    m0 = m_in * fin
    g_clean = _scrub(grads)
    d_clean = _scrub(deltas)
    n = torch.clamp(m0.sum(), min=1.0)
    g1 = torch.tensordot(m0, g_clean.float(), dims=1) / n
    g1_sq = (g1 * g1).sum()
    inner = folb_scores(g_clean, g1)
    weights, scores, m0, nf, nc, ng = _guard_algebra(
        inner, g1_sq, norms_sq, finite, m_in, tau, alpha, psi_gamma, guard)
    new_w = folb_apply(w, d_clean, weights)
    new_w = torch.where(m0.sum() > 0.0, new_w, w)
    ginfo = {"mask": m0, "n_nonfinite": nf, "n_clipped": nc, "n_gated": ng}
    return new_w, scores, ginfo
