"""Flat-buffer parameter layout (``repro.core.flat``).

A parameter dict becomes one contiguous vector: leaves in sorted-key order
(``jax.tree_util``'s order, which the reference's flat layout follows),
each raveled in C order, zero-padded to a multiple of ``TILE_D`` so the
aggregation kernels stream whole tiles.  Client deltas/grads stack into
``(K, D_pad)`` buffers.

Buffer dtype: parameters stay fp32 so the flat carry round-trips exactly;
grad/delta buffers may be bf16 (round-to-nearest-even, as ``jnp.astype``),
halving the bytes the aggregation kernels stream.  The padding lanes are
zero and stay zero through every aggregation rule.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.tree import Params, names

TILE_D = 1024   # the aggregation kernels' streaming tile (reference TILE_D)


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static recipe for flattening/unflattening one parameter dict."""
    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    pad_to: int = TILE_D
    buf_dtype: torch.dtype = torch.float32

    @property
    def sizes(self) -> Tuple[int, ...]:
        out = []
        for s in self.shapes:
            n = 1
            for d in s:
                n *= d
            out.append(n)
        return tuple(out)

    @property
    def D(self) -> int:
        """Unpadded parameter count."""
        return sum(self.sizes)

    @property
    def D_pad(self) -> int:
        """Parameter count rounded up to the kernel streaming tile."""
        return self.D + (-self.D) % self.pad_to


def spec_of(tree: Params, pad_to: int = TILE_D,
            buf_dtype: torch.dtype = torch.float32) -> FlatSpec:
    """Build the FlatSpec of a (single, unstacked) parameter dict."""
    ks = tuple(names(tree))
    return FlatSpec(names=ks,
                    shapes=tuple(tuple(tree[k].shape) for k in ks),
                    dtypes=tuple(tree[k].dtype for k in ks),
                    pad_to=pad_to, buf_dtype=buf_dtype)


def with_buf_dtype(spec: FlatSpec, buf_dtype: torch.dtype) -> FlatSpec:
    """The same recipe targeting another buffer dtype (bf16 grad/delta
    buffers of an fp32 parameter spec)."""
    return dataclasses.replace(spec, buf_dtype=buf_dtype)


def ravel(spec: FlatSpec, tree: Params) -> torch.Tensor:
    """Parameter dict -> (D_pad,) buf_dtype vector, zero past D."""
    flat = torch.cat([tree[k].reshape(-1).to(spec.buf_dtype)
                      for k in spec.names])
    pad = spec.D_pad - spec.D
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def ravel_stacked(spec: FlatSpec, stacked: Params) -> torch.Tensor:
    """Dict with a leading client axis K -> (K, D_pad) buf_dtype buffer."""
    K = stacked[spec.names[0]].shape[0]
    flat = torch.cat([stacked[k].reshape(K, -1).to(spec.buf_dtype)
                      for k in spec.names], dim=1)
    pad = spec.D_pad - spec.D
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def unravel(spec: FlatSpec, flat: torch.Tensor) -> Params:
    """(D_pad,) or (D,) vector -> dict with the spec's shapes/dtypes."""
    out, off = {}, 0
    for k, shape, dtype, n in zip(spec.names, spec.shapes, spec.dtypes,
                                  spec.sizes):
        out[k] = flat[off:off + n].reshape(shape).to(dtype)
        off += n
    return out


def unravel_stacked(spec: FlatSpec, flat: torch.Tensor) -> Params:
    """(K, D_pad) buffer -> dict with a leading K axis per leaf."""
    K = flat.shape[0]
    out, off = {}, 0
    for k, shape, dtype, n in zip(spec.names, spec.shapes, spec.dtypes,
                                  spec.sizes):
        out[k] = flat[:, off:off + n].reshape((K,) + shape).to(dtype)
        off += n
    return out
