"""The SSD recurrence (the Mamba2 scan): a CUDA kernel written by hand for
Hopper (``csrc/ssm_scan.cu``) beside its plain PyTorch version
``ssd_chunked``, the reference model's chunked form
(``repro.models.ssm.ssd_chunked``).

    h_t = exp(loga_t) · h_{t-1} + w_t · B_t x_tᵀ ;   y_t = C_t · h_t

It replaces the Pallas kernel ``repro/kernels/ssm_scan.py``, and also
returns the final state, which decode needs.  It takes the model's layout:
x ``(B, S, H, P)``, loga/w ``(B, S, H)``, B/C ``(B, S, G, N)`` with G = 1
(shared by all heads, as Mamba2's) or G = H.  The Pallas kernel's per-head
``(BH, S, P)`` inputs are the case B = BH, H = G = 1.

The kernel walks the steps in order with the ``(P, N)`` state in
registers, one thread per state row, the rows of a head split over blocks
of at most 256 threads; the plain version works chunk by chunk (``chunk``
divides S).
Both compute the same function, rounded in different orders.

Dispatch: given CPU tensors the wrapper runs the plain version, and only
because the tensors lie on the CPU; given CUDA tensors it launches the
kernel or raises.  ``ssd_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

STATE_SIZES = (8, 16, 32, 64, 128)   # N the kernel is built for
MAX_HEAD_DIM = 1024                  # P: one thread per state row


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., T) per-step log decays -> (..., T, T) lower-triangular
    cumulative sums L[t, s] = sum_{r=s+1..t} a_r (-inf above diagonal)."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    L = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return torch.where(mask, L, -torch.inf)


def ssd_chunked(x, loga, w, Bm, Cm, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked linear recurrence (SSD / gated linear attention), plain
    PyTorch.

    x:    (B, S, H, P)    head inputs
    loga: (B, S, H)       per-step log decay
    w:    (B, S, H)       input weights
    Bm:   (B, S, G, N)    input maps, G in {1, H} groups
    Cm:   (B, S, G, N)    output maps
    returns y: (B, S, H, P), final_state: (B, H, P, N) fp32
    """
    B, S, H, P = x.shape
    G, N = Bm.shape[-2], Bm.shape[-1]
    hg = H // G
    if S % chunk:
        raise ValueError(f"chunk {chunk} does not divide S = {S}")
    nc = S // chunk
    xs = x.reshape(B, nc, chunk, G, hg, P)
    ws = w.reshape(B, nc, chunk, G, hg)
    Bs = Bm.reshape(B, nc, chunk, G, N)
    Cs = Cm.reshape(B, nc, chunk, G, N)
    As = loga.reshape(B, nc, chunk, G, hg)
    h = (torch.zeros((B, G, hg, P, N), dtype=torch.float32, device=x.device)
         if init_state is None
         else init_state.reshape(B, G, hg, P, N).float())
    ys = []
    for c in range(nc):
        xc, wc, Bc, Cc = xs[:, c], ws[:, c], Bs[:, c], Cs[:, c]
        a_h = As[:, c].movedim(1, -1)                      # (B,G,hg,T)
        L = torch.exp(_segsum(a_h))                        # (B,G,hg,T,T)
        # intra-chunk term
        scores = torch.einsum("btgn,bsgn->bgts", Cc, Bc)
        y = torch.einsum("bgts,bghts,bsgh,bsghp->btghp", scores, L, wc, xc)
        # inter-chunk contribution from the entering state
        decay_in = torch.exp(torch.cumsum(a_h, dim=-1))    # (B,G,hg,T)
        y = y + torch.einsum("btgn,bghpn,bght->btghp", Cc, h, decay_in)
        # state update: h' = exp(sum a) h + sum_s exp(sum_{r>s} a) w_s B_s x_s
        decay_to_end = torch.exp(
            torch.cumsum(a_h.flip(-1), dim=-1).flip(-1) - a_h)
        state = torch.einsum("bghs,bsgh,bsgn,bsghp->bghpn",
                             decay_to_end, wc, Bc, xc)
        chunk_decay = torch.exp(a_h.sum(dim=-1))           # (B,G,hg)
        h = h * chunk_decay[..., None, None] + state
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    return y, h.reshape(B, H, P, N)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature."""
    lib = build.load("ssm_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
    lib.ssd_scan_launch.restype = i32
    return lib


def _check(x, loga, w, Bm, Cm) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, _ = x.shape
    if loga.shape != (B, S, H) or w.shape != (B, S, H):
        raise ValueError(f"loga and w must be {(B, S, H)}, got "
                         f"{tuple(loga.shape)}, {tuple(w.shape)}")
    if Bm.dim() != 4 or Bm.shape != Cm.shape or Bm.shape[:2] != (B, S) \
            or H % Bm.shape[2]:
        raise ValueError(f"Bm and Cm must be (B, S, G, N) with G dividing "
                         f"H = {H}, got {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    devices = {t.device for t in (x, loga, w, Bm, Cm)}
    if len(devices) != 1:
        raise ValueError(f"the inputs lie on several devices: {devices}")


def ssd_scan(x: torch.Tensor, loga: torch.Tensor, w: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over the model's layout (see the module docstring) -> (y
    (B, S, H, P) in x's dtype, final state (B, H, P, N) fp32).  ``chunk``
    is the plain version's chunk length; the kernel ignores it."""
    _check(x, loga, w, Bm, Cm)
    if x.device.type == "cpu":
        return ssd_chunked(x, loga, w, Bm, Cm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {x.device}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    for name, t in (("x", x), ("loga", loga), ("w", w), ("Bm", Bm),
                    ("Cm", Cm)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"the kernel takes contiguous fp32 inputs; "
                             f"{name} is {t.dtype}, contiguous="
                             f"{t.is_contiguous()}")
    if N not in STATE_SIZES or not 1 <= P <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes N in {STATE_SIZES} and P <= "
                         f"{MAX_HEAD_DIM}, got N = {N}, P = {P}")
    y = torch.empty_like(x)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().ssd_scan_launch(
        x.data_ptr(), loga.data_ptr(), w.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h_final.data_ptr(), B, S, H, P, G, N,
        stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y, h_final


ssd_scan.launches = 0
