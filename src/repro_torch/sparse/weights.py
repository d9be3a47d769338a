"""Cached weight-side plans.

At inference a weight matrix (with its pruning mask applied) is static, so
its half of the two-level bitmap — per-column k-slice activity — never
changes.  :class:`PlannedWeight` holds it, built once at load; each step
then only ANDs it with the activation side.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.sparse import plan as pln


@dataclasses.dataclass(frozen=True)
class PlannedWeight:
    """A (masked) weight matrix plus its precomputed activity.

    w            : (K, N) weights, pruning mask already applied, or
                   (E, K, N) stacked per-problem weights.
    slice_act    : (S, N) bool per-column k-slice activity (or (E, S, N)).
    slice_k      : granularity of ``slice_act``.
    elem_act     : optional (K, Nt) bool per-block-col element
                   k-activity, or (E, K, Nt) (the ``condense="k"``
                   planning input).
    elem_block_n : block_n granularity of ``elem_act`` (0 = not cached).
    site         : optional :class:`~repro_torch.sparse.site.OpSite`.
    """
    w: torch.Tensor
    slice_act: torch.Tensor
    slice_k: int
    elem_act: Optional[torch.Tensor] = None
    elem_block_n: int = 0
    site: Optional[object] = None

    def col_slice_activity(self, slice_k: int) -> torch.Tensor:
        """(..., S', N) activity at ``slice_k`` (cached when it matches)."""
        if slice_k == self.slice_k:
            return self.slice_act
        return pln.slice_activity_rhs(self.w, slice_k)

    def col_element_activity(self, block_n: int) -> torch.Tensor:
        """(..., K, Nt) element k-activity at ``block_n`` (cached when it
        matches, else re-reduced from the stored masked values)."""
        if self.elem_act is not None and block_n == self.elem_block_n:
            return self.elem_act
        return pln.element_activity_rhs(self.w, block_n)


def plan_weight(w: torch.Tensor, mask: Optional[torch.Tensor] = None,
                slice_k: int = pln.SLICE_K,
                block_n: Optional[int] = None) -> PlannedWeight:
    """Build the static weight-side plan of a (K, N) or stacked (E, K, N)
    weight (once per layer).

    ``mask`` is the pruning mask, applied to the stored values; ``block_n``
    also memoizes the element-granular k-activity at that block width.
    """
    if w.ndim not in (2, 3):
        raise ValueError(f"plan_weight expects 2-D or 3-D, got "
                         f"{tuple(w.shape)}")
    if mask is not None:
        w = w * mask.to(w.dtype)
    return PlannedWeight(
        w=w, slice_act=pln.slice_activity_rhs(w, slice_k), slice_k=slice_k,
        elem_act=pln.element_activity_rhs(w, block_n) if block_n else None,
        elem_block_n=block_n or 0)


def as_planned(w, slice_k: int = pln.SLICE_K) -> PlannedWeight:
    """A :class:`PlannedWeight` of ``w``; a PlannedWeight passes through."""
    if isinstance(w, PlannedWeight):
        return w
    return plan_weight(torch.as_tensor(w), slice_k=slice_k)


def plan_layer_weights(params, keys=("w_up", "w_down", "w_gate"),
                       slice_k: int = pln.SLICE_K,
                       block_n: Optional[int] = None) -> dict:
    """The plans dict for one layer's weights (2-D, or an MoE layer's
    stacked (E, K, N)): slice activities at the granularity the dispatch
    clamps to, keyed like the weights, plus ``"<key>@elem"`` element
    activities when ``block_n`` is given."""
    plans = {
        k: pln.slice_activity_rhs(
            params[k], pln.effective_slice_k(params[k].shape[-2], slice_k))
        for k in keys if k in params}
    if block_n:
        for k in keys:
            if k in params:
                plans[f"{k}@elem"] = pln.element_activity_rhs(
                    params[k], block_n)
    return plans


def planned_or_array(w: torch.Tensor, plans, key: str, dtype, slice_k: int,
                     block_n: int = 0, site=None):
    """Cast ``w`` to the activation dtype and, when ``plans`` carries
    ``key``, wrap it as a :class:`PlannedWeight`; otherwise return the
    bare tensor and let the dispatch plan it per call."""
    w = w.to(dtype)
    if plans is not None and key in plans:
        elem = plans.get(f"{key}@elem") if block_n else None
        return PlannedWeight(
            w=w, slice_act=plans[key],
            slice_k=pln.effective_slice_k(w.shape[-2], slice_k),
            elem_act=elem, elem_block_n=block_n if elem is not None else 0,
            site=site)
    return w
