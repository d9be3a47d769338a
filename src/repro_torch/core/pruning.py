"""Weight pruning — the static (weight) side of dual-side sparsity.

The JAX package's ``core/pruning.py`` as torch functions, with its names,
signatures and masks bit for bit:

* :func:`magnitude_mask`      — magnitude pruning at a target ratio.
* :func:`block_mask`          — block pruning at the kernels' skip
  granularity (k-slice × output block).
* :func:`agp_sparsity`        — Automated Gradual Pruning schedule s(t).
* :func:`structured_24_mask`  — 2:4 fine-grained structural pruning.
* :func:`vectorwise_mask`     — a fixed keep-count inside each 1×L vector.
* :func:`prune_tree` / :func:`apply_masks` — masks over a model's named
  parameters (an ``nn.Module``) or a dict of tensors.

Ranks come from a stable ascending double ``argsort`` (later indices
rank higher among equals), as ``jnp.argsort`` gives them: ties are common
(bf16 tile norms take few distinct values), so the tie-break decides
which tiles or elements survive.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def _check_sparsity(sparsity: float) -> None:
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0,1), got {sparsity}")


def _rank(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Each element's place in a stable ascending sort along ``dim``."""
    return torch.argsort(torch.argsort(x, dim=dim, stable=True), dim=dim,
                         stable=True)


def magnitude_mask(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Keep the top-(1-sparsity) fraction by |magnitude| (per tensor);
    magnitudes equal to the threshold drop (strict ``>``)."""
    _check_sparsity(sparsity)
    k = int(round(w.numel() * (1.0 - sparsity)))
    if k == w.numel():
        return torch.ones_like(w, dtype=torch.bool)
    mag = w.abs()
    thresh = torch.sort(mag.reshape(-1)).values[w.numel() - k - 1]
    return mag > thresh


def agp_sparsity(step: int, *, s_init: float = 0.0, s_final: float = 0.9,
                 t_start: int = 0, t_end: int = 1000) -> float:
    """AGP cubic schedule: s(t) = s_f + (s_i - s_f)(1 - (t-t0)/(t1-t0))^3."""
    t = min(max(step, t_start), t_end)
    frac = (t - t_start) / max(t_end - t_start, 1)
    return s_final + (s_init - s_final) * (1.0 - frac) ** 3


def block_mask(w: torch.Tensor, sparsity: float,
               block: Tuple[int, int] = (128, 128)) -> torch.Tensor:
    """Block pruning: drop whole (bk × bn) tiles of w (K, N) by Frobenius
    norm, keeping exactly round(tiles × (1 − sparsity)) by rank.

    The squares and their tile sums are taken in w's dtype, as the JAX
    package takes them: for bf16, each square rounded to bf16, then the
    sum (accumulated in float32) rounded once.  Ties among the norms go
    to the later tile in row-major order.
    """
    _check_sparsity(sparsity)
    k, n = w.shape
    bk, bn = block
    kt, nt = -(-k // bk), -(-n // bn)
    sq = torch.square(w)
    if (kt * bk, nt * bn) != (k, n):
        sq = F.pad(sq, (0, nt * bn - n, 0, kt * bk - k))
    norms = sq.reshape(kt, bk, nt, bn).sum(dim=(1, 3))           # (Kt, Nt)
    del sq
    keep = int(round(kt * nt * (1.0 - sparsity)))
    if keep >= kt * nt:
        return torch.ones_like(w, dtype=torch.bool)
    tile_keep = (_rank(norms.reshape(-1)) >= kt * nt - keep).reshape(kt, nt)
    full = tile_keep.repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    return full[:k, :n]


def structured_24_mask(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """2-out-of-4 structural mask along ``axis`` (Ampere sparse TC)."""
    w = torch.movedim(w, axis, -1)
    *lead, n = w.shape
    if n % 4:
        raise ValueError(f"axis length {n} not a multiple of 4")
    g = w.abs().reshape(*lead, n // 4, 4)
    mask = (_rank(g) >= 2).reshape(*lead, n)      # the 2 largest of each 4
    return torch.movedim(mask, -1, axis)


def vectorwise_mask(w: torch.Tensor, sparsity: float = 0.75, vec: int = 32,
                    axis: int = -1) -> torch.Tensor:
    """Vector-wise pruning: a fixed keep-count inside each 1×vec vector
    (the last one zero-padded)."""
    w = torch.movedim(w, axis, -1)
    *lead, n = w.shape
    pad = (-n) % vec
    g = F.pad(w, (0, pad)).abs().reshape(*lead, (n + pad) // vec, vec)
    keep = max(int(round(vec * (1.0 - sparsity))), 1)
    mask = (_rank(g) >= vec - keep).reshape(*lead, n + pad)[..., :n]
    return torch.movedim(mask, -1, axis)


def _named(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def prune_tree(
    params: Params,
    sparsity: float,
    *,
    method: str = "magnitude",
    predicate: Optional[Callable[[str, torch.Tensor], bool]] = None,
) -> Dict[str, torch.Tensor]:
    """Masks for ``params`` (an ``nn.Module``'s named parameters or a dict
    of tensors), keyed by name.

    predicate(name, tensor) selects which tensors are prunable (default:
    every tensor with ndim >= 2 — weight matrices, not biases or norms);
    the others get all-ones masks.  ``method``: "magnitude", "2:4" or
    "vectorwise".
    """
    if predicate is None:
        def predicate(name, t):
            return t.ndim >= 2

    def mask_for(name: str, t: torch.Tensor) -> torch.Tensor:
        if not predicate(name, t):
            return torch.ones_like(t, dtype=torch.bool)
        if method == "magnitude":
            return magnitude_mask(t, sparsity)
        if method == "2:4":
            return structured_24_mask(t)
        if method == "vectorwise":
            return vectorwise_mask(t, sparsity)
        raise ValueError(f"unknown pruning method {method!r}")

    with torch.no_grad():
        return {name: mask_for(name, t)
                for name, t in _named(params).items()}


def apply_masks(params: Params, masks: Mapping[str, torch.Tensor]) -> Params:
    """Multiply each named tensor by its mask.  A dict gets a new dict of
    masked tensors, as the JAX function returns a new tree; an
    ``nn.Module``'s parameters are masked in place (no second copy of the
    weights) and the module is returned."""
    with torch.no_grad():
        if isinstance(params, nn.Module):
            named = dict(params.named_parameters())
            for name, m in masks.items():
                named[name].mul_(m.to(named[name].dtype))
            return params
        return {name: t * masks[name].to(t.dtype)
                for name, t in params.items()}
