"""Entry points of the port's kernels (``repro.kernels.ops``), single
device.

  * ``flash_attention`` (``kernels.flash_attention``), ``ssd_scan``
    (``kernels.ssm_scan``) and ``slstm_scan`` (``kernels.slstm_scan``): the
    transformer zoo's three kernels, each with its ``launches`` counter.

The fused FOLB aggregation, buffer- and dict-level:

  * ``folb_aggregate_buffers``: pre-raveled flat buffers — fp32 ``(D,)``
    params, bf16-or-fp32 ``(K, D)`` grads/deltas — through the kernels.
  * ``folb_staleness_buffers``: the staleness/mask rule (masked g1,
    (1+τ)^{−α} scores) on flat buffers.
  * ``folb_aggregate_tree`` / ``folb_staleness_tree`` /
    ``folb_staleness_slots_tree``: ravel the parameter dicts (bf16 grad/
    delta buffers by default, half the bytes streamed; fp32 accumulation
    stays inside the kernels), call the buffer level, unravel.

``guard`` (a static ``kernels.guard.GuardConfig`` or None) selects the
guarded aggregation — the plain rule is its τ = 0, full-mask case — and
the return grows a third ``ginfo`` element (post-guard mask and rejection
counters).  ``guard=None`` runs the unguarded code path.  The reference's
``mesh`` (D-sharded) variant is not ported yet; passing it raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import flat as flat_lib
from repro_torch.kernels import folb_aggregate as _folb
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.guard import as_guard
from repro_torch.kernels.slstm_scan import slstm_scan
from repro_torch.kernels.ssm_scan import ssd_scan

# default storage dtype of the (K, D) grad/delta buffers (reference ops.py)
DEFAULT_BUF_DTYPE = torch.bfloat16


def reset_launches() -> None:
    """Zero the launch counter of every kernel of the port."""
    _folb.reset_launches()
    flash_attention.launches = 0
    ssd_scan.launches = 0
    slstm_scan.launches = 0


def launches() -> dict:
    """Each kernel's launch count since the last ``reset_launches``."""
    return {"folb_scores": _folb.folb_scores.launches,
            "folb_apply": _folb.folb_apply.launches,
            "guard_stats": _folb.guard_stats.launches,
            "flash_attention": flash_attention.launches,
            "ssd_scan": ssd_scan.launches,
            "slstm_scan": slstm_scan.launches}


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("D-sharded aggregation (mesh=) is not "
                                  "ported yet")


def _psi_gamma(psi_gamma, K: int, device) -> torch.Tensor:
    return (torch.zeros((K,), dtype=torch.float32, device=device)
            if psi_gamma is None else psi_gamma.float())


def folb_aggregate_buffers(w: torch.Tensor, deltas: torch.Tensor,
                           grads: torch.Tensor,
                           psi_gamma: Optional[torch.Tensor] = None,
                           mesh=None, guard=None) -> Tuple:
    """Single-set FOLB on flat buffers -> (new fp32 (D,) params, (K,)
    scores[, ginfo with ``guard``]).

    g1 is the plain fp32 mean of the grads and ||g1||² its plain sum of
    squares, as in the reference; the streaming passes are kernels."""
    _no_mesh(mesh)
    K = grads.shape[0]
    pg = _psi_gamma(psi_gamma, K, grads.device)
    if as_guard(guard) is not None:
        return folb_staleness_buffers(
            w, deltas, grads, torch.zeros((K,), device=grads.device), 0.0,
            psi_gamma=pg, guard=guard)
    g1 = grads.float().mean(dim=0)
    g1_sq = (g1 * g1).sum()
    return _folb.folb_aggregate(w, deltas, grads, g1, pg, g1_sq)


def folb_staleness_buffers(w: torch.Tensor, deltas: torch.Tensor,
                           grads: torch.Tensor, tau: torch.Tensor, alpha,
                           psi_gamma: Optional[torch.Tensor] = None,
                           mask: Optional[torch.Tensor] = None, mesh=None,
                           guard=None) -> Tuple:
    """Staleness-discounted flat FOLB (masked g1, (1+τ)^{−α} scores) ->
    (new_w, scores[, ginfo with ``guard``]); matches
    ``core.aggregation.folb_staleness`` on the flattened problem."""
    _no_mesh(mesh)
    K = grads.shape[0]
    dev = grads.device
    pg = _psi_gamma(psi_gamma, K, dev)
    m = torch.ones((K,), dtype=torch.float32, device=dev) if mask is None \
        else mask
    tau = tau.float()
    # a Python float exponent stays on the host: no copy to the device
    alpha = alpha.float() if isinstance(alpha, torch.Tensor) else \
        float(alpha)
    if as_guard(guard) is not None:
        return _folb.folb_aggregate_stale_guarded(w, deltas, grads, tau,
                                                  alpha, pg, m, guard)
    return _folb.folb_aggregate_stale(w, deltas, grads, tau, alpha, pg, m)


def _ravel_problem(params, deltas_stacked, grads_stacked, buf_dtype):
    """(spec, flat fp32 w, buf_dtype (K, D_pad) delta and grad buffers)."""
    spec = flat_lib.spec_of(params)
    bspec = flat_lib.with_buf_dtype(spec, buf_dtype)
    w = flat_lib.ravel(spec, params)
    deltas = flat_lib.ravel_stacked(bspec, deltas_stacked)
    grads = flat_lib.ravel_stacked(bspec, grads_stacked)
    return spec, w, deltas, grads


def _unravel_result(spec, out: Tuple) -> Tuple:
    return (flat_lib.unravel(spec, out[0]),) + tuple(out[1:])


def folb_aggregate_tree(params, deltas_stacked, grads_stacked,
                        psi_gammas: Optional[torch.Tensor] = None,
                        buf_dtype: torch.dtype = DEFAULT_BUF_DTYPE,
                        mesh=None, guard=None) -> Tuple:
    """Dict front-end: ravel into flat (K, D_pad) buffers of ``buf_dtype``,
    run the fused aggregation, unravel -> (new params, (K,) scores[,
    ginfo with ``guard``])."""
    _no_mesh(mesh)
    spec, w, deltas, grads = _ravel_problem(params, deltas_stacked,
                                            grads_stacked, buf_dtype)
    return _unravel_result(spec, folb_aggregate_buffers(
        w, deltas, grads, psi_gamma=psi_gammas, guard=guard))


def folb_staleness_tree(params, deltas_stacked, grads_stacked,
                        tau: torch.Tensor, alpha: float = 0.0,
                        psi_gammas: Optional[torch.Tensor] = None,
                        mask: Optional[torch.Tensor] = None,
                        buf_dtype: torch.dtype = DEFAULT_BUF_DTYPE,
                        mesh=None, guard=None) -> Tuple:
    """Dict front-end of the staleness rule: ravel, run, unravel ->
    (new params, scores[, ginfo with ``guard``]); matches
    ``core.aggregation.folb_staleness``."""
    _no_mesh(mesh)
    spec, w, deltas, grads = _ravel_problem(params, deltas_stacked,
                                            grads_stacked, buf_dtype)
    return _unravel_result(spec, folb_staleness_buffers(
        w, deltas, grads, tau, alpha, psi_gamma=psi_gammas, mask=mask,
        guard=guard))


def folb_staleness_slots_tree(params, deltas_slots, grads_slots,
                              slot_mask: torch.Tensor,
                              slot_tau: torch.Tensor, alpha: float = 0.0,
                              psi_gammas: Optional[torch.Tensor] = None,
                              buf_dtype: torch.dtype = DEFAULT_BUF_DTYPE,
                              mesh=None, guard=None) -> Tuple:
    """Fixed-budget masked-slot stale aggregation: the stacked client axis
    is a static slot budget, and invalid slots are excluded through
    ``slot_mask``.  Contract (as the reference's):

      * a masked slot never contributes — finite garbage in a masked row
        gives a bit-identical aggregate, because every masked term enters
        the reductions as an exact ``0.0 * x``;
      * an all-masked budget returns ``params`` unchanged, bit-exact — not
        ``params + 0.0``, which would flip negative zeros.

    With ``guard`` the guarded aggregation extends the contract to rejected
    slots (its all-rejected return is decided on the post-guard mask) and
    the return grows a third ``ginfo`` element."""
    _no_mesh(mesh)
    spec, w, deltas, grads = _ravel_problem(params, deltas_slots,
                                            grads_slots, buf_dtype)
    out = folb_staleness_buffers(w, deltas, grads, slot_tau, alpha,
                                 psi_gamma=psi_gammas, mask=slot_mask,
                                 guard=guard)
    if guard is None:
        new_flat, scores = out
        new_flat = torch.where(slot_mask.sum() > 0.0, new_flat, w)
        out = (new_flat, scores)
    return _unravel_result(spec, out)
