"""Buffer- and dict-level entry points of the fused FOLB aggregation
(``repro.kernels.ops``), single device and unguarded.

  * ``folb_aggregate_buffers``: pre-raveled flat buffers — fp32 ``(D,)``
    params, bf16-or-fp32 ``(K, D)`` grads/deltas — through the two kernels.
  * ``folb_aggregate_tree``: ravel the parameter dicts (bf16 grad/delta
    buffers by default, half the bytes streamed; fp32 accumulation stays
    inside the kernels), call the buffer level, unravel.

The reference's ``mesh`` (D-sharded) and ``guard`` (robust aggregation)
variants are not ported yet; passing either raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import flat as flat_lib
from repro_torch.kernels import folb_aggregate as _folb

# default storage dtype of the (K, D) grad/delta buffers (reference ops.py)
DEFAULT_BUF_DTYPE = torch.bfloat16


def _not_ported(mesh, guard) -> None:
    if mesh is not None:
        raise NotImplementedError("D-sharded aggregation (mesh=) is not "
                                  "ported yet")
    if guard is not None:
        raise NotImplementedError("the update guard (guard=) is not ported "
                                  "yet")


def folb_aggregate_buffers(w: torch.Tensor, deltas: torch.Tensor,
                           grads: torch.Tensor,
                           psi_gamma: Optional[torch.Tensor] = None,
                           mesh=None, guard=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-set FOLB on flat buffers -> (new fp32 (D,) params, (K,) scores).

    g1 is the plain fp32 mean of the grads and ||g1||² its plain sum of
    squares, as in the reference; the two streaming passes are kernels."""
    _not_ported(mesh, guard)
    K = grads.shape[0]
    pg = (torch.zeros((K,), dtype=torch.float32, device=grads.device)
          if psi_gamma is None else psi_gamma.float())
    g1 = grads.float().mean(dim=0)
    g1_sq = (g1 * g1).sum()
    return _folb.folb_aggregate(w, deltas, grads, g1, pg, g1_sq)


def folb_aggregate_tree(params, deltas_stacked, grads_stacked,
                        psi_gammas: Optional[torch.Tensor] = None,
                        buf_dtype: torch.dtype = DEFAULT_BUF_DTYPE,
                        mesh=None, guard=None) -> Tuple:
    """Dict front-end: ravel into flat (K, D_pad) buffers of ``buf_dtype``,
    run the fused aggregation, unravel -> (new params, (K,) scores)."""
    _not_ported(mesh, guard)
    spec = flat_lib.spec_of(params)
    bspec = flat_lib.with_buf_dtype(spec, buf_dtype)
    w = flat_lib.ravel(spec, params)
    deltas = flat_lib.ravel_stacked(bspec, deltas_stacked)
    grads = flat_lib.ravel_stacked(bspec, grads_stacked)
    new_flat, scores = folb_aggregate_buffers(w, deltas, grads,
                                              psi_gamma=psi_gammas)
    return flat_lib.unravel(spec, new_flat), scores
