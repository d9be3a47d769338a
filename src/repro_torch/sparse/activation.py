"""Bitmap-carrying activations.

The activations that create genuine zeros (ReLU, squared-ReLU) are where
the dynamic side of dual-side sparsity is born.  :class:`SparseActivation`
captures the non-zero structure right there — a packed element bitmap
plus per-row k-slice activity — so the next projection's planner reads
cached metadata instead of re-deriving ``a != 0`` from the values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import bitmap as bm
from repro_torch.sparse import plan as pln


@dataclasses.dataclass(frozen=True)
class SparseActivation:
    """An activation tensor plus its sparsity metadata.

    values    : (..., K) the activation values.
    bitmap    : (..., ceil(K/32)) packed int32 element bitmap over K.
    slice_act : (..., S) bool per-row k-slice activity at ``slice_k``.
    slice_k   : granularity of ``slice_act``.
    """
    values: torch.Tensor
    bitmap: torch.Tensor
    slice_act: torch.Tensor
    slice_k: int

    def flatten_leading(self) -> "SparseActivation":
        """Collapse all leading axes: (..., K) → (T, K)."""
        return SparseActivation(
            values=self.values.reshape(-1, self.values.shape[-1]),
            bitmap=self.bitmap.reshape(-1, self.bitmap.shape[-1]),
            slice_act=self.slice_act.reshape(-1, self.slice_act.shape[-1]),
            slice_k=self.slice_k)

    def element_mask(self) -> torch.Tensor:
        """The exact (..., K) element mask, unpacked from the bitmap."""
        k = self.values.shape[-1]
        return bm.unpack_bits(self.bitmap, axis=-1)[..., :k]

    def row_slice_activity(self, slice_k: int) -> torch.Tensor:
        """Per-row activity at ``slice_k`` (cached when it matches,
        otherwise re-derived from the bitmap, never from the values)."""
        if slice_k == self.slice_k:
            return self.slice_act
        return pln.slice_activity_lhs(self.element_mask(), slice_k)


def sparsify(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
             slice_k: int = pln.SLICE_K) -> SparseActivation:
    """Wrap a tensor whose zeros are already in place (``mask`` lets a
    caller that knows the zero structure skip the ``x != 0`` compare)."""
    if mask is None:
        mask = x != 0
    return SparseActivation(
        values=x,
        bitmap=bm.pack_bits_padded(mask, axis=-1),
        slice_act=pln.slice_activity_lhs(mask, slice_k),
        slice_k=slice_k)


def relu(x: torch.Tensor, slice_k: int = pln.SLICE_K) -> SparseActivation:
    """ReLU with the bitmap taken from the gating compare."""
    return sparsify(torch.clamp(x, min=0), mask=x > 0, slice_k=slice_k)


def relu2(x: torch.Tensor, slice_k: int = pln.SLICE_K) -> SparseActivation:
    """Squared-ReLU (nemotron): the zero structure of ReLU."""
    r = torch.clamp(x, min=0)
    return sparsify(r * r, mask=x > 0, slice_k=slice_k)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form (``F.gelu`` defaults to
    erf)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def activate(h: torch.Tensor, kind: str, slice_k: int = pln.SLICE_K, *,
             gate: Optional[torch.Tensor] = None):
    """The sparse-path MLP activation for the ported MLP kinds: relu and
    relu2 make genuine zeros and return a :class:`SparseActivation`;
    swiglu (``silu(gate) * h``, ``gate`` the gate projection) and gelu are
    dense almost surely and return a plain tensor, which the dispatch
    plans from its values."""
    if kind == "relu":
        return relu(h, slice_k)
    if kind == "relu2":
        return relu2(h, slice_k)
    if kind == "swiglu":
        if gate is None:
            raise ValueError("swiglu needs the gate projection (gate=...)")
        return torch.nn.functional.silu(gate) * h
    if kind == "gelu":
        return gelu(h)
    raise ValueError(f"mlp_type {kind!r} is not ported (relu, relu2, gelu, "
                     "swiglu are)")
