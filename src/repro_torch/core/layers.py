"""Sparsity-aware linear layers (``DualSparseLinear``), as the JAX
package's ``core/layers.py``.

A drop-in projection in three modes:

* ``dense``  — plain matmul (the paper's CUTLASS baseline);
* ``weight`` — single-side: masked weights, only weight-side skips
  counted (the Sparse Tensor Core [72] baseline);
* ``dual``   — weight mask AND the activation's dynamic sparsity, through
  the dispatch (K1 with ``use_kernel``), with step counts.

Every mode computes ``x @ (w * mask)``.  :func:`plan_sparse_linear`
caches the static weight-side plan once, so each call plans only the
activation side.  Parameters are a dict (``w``, ``mask``, optional
``b``), the JAX package's convention.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import device as devmod
from repro_torch.core import stats


@dataclasses.dataclass(frozen=True)
class SparseLinearConfig:
    in_features: int
    out_features: int
    mode: str = "dense"            # dense | weight | dual
    use_bias: bool = False
    block_m: int = 128
    block_n: int = 128
    block_k: int = 128             # k-slice granularity of the skip unit
    use_kernel: bool = False       # K1 (its plain walk on the CPU)
    collect_stats: bool = False


def init_sparse_linear(generator: torch.Generator, cfg: SparseLinearConfig,
                       dtype=torch.float32, device=None) -> dict:
    """``w`` uniform in ±1/sqrt(in_features) from ``generator`` (which
    lives on ``device``), an all-True ``mask``, zero ``b`` with
    ``use_bias``.  ``device=None`` means the card."""
    dev = devmod.resolve(device)
    scale = 1.0 / (cfg.in_features ** 0.5)
    shape = (cfg.in_features, cfg.out_features)
    u = torch.rand(shape, generator=generator, device=dev)
    params = {"w": ((2 * u - 1) * scale).to(dtype),
              "mask": torch.ones(shape, dtype=torch.bool, device=dev)}
    if cfg.use_bias:
        params["b"] = torch.zeros(cfg.out_features, dtype=dtype, device=dev)
    return params


def plan_sparse_linear(params: dict, cfg: SparseLinearConfig) -> dict:
    """A new params dict with a ``plan`` entry: the masked weight's
    :class:`~repro_torch.sparse.weights.PlannedWeight`, at the slice
    granularity the dispatch clamps to (call once the mask is final)."""
    from repro_torch.sparse import plan as pln
    from repro_torch.sparse import weights as spw
    out = dict(params)
    out["plan"] = spw.plan_weight(
        params["w"], mask=params["mask"],
        slice_k=pln.effective_slice_k(cfg.in_features, cfg.block_k))
    return out


def apply_sparse_linear(params: dict, x: torch.Tensor,
                        cfg: SparseLinearConfig, *, device=None
                        ) -> Tuple[torch.Tensor,
                                   Optional[stats.StepCounts]]:
    """x (..., in_features) → (y (..., out_features), StepCounts or None).
    Stats come with ``collect_stats``, and always in dual mode with the
    kernel.  ``device=None`` means the card."""
    from repro_torch.sparse import dispatch as spd
    devmod.check_on(x, devmod.resolve(device), "x")
    if cfg.mode in ("weight", "dual"):
        w = params.get("plan")
        if w is None:       # unplanned: mask now, plan per call
            w = params["w"] * params["mask"].to(params["w"].dtype)
    else:
        w = params["w"]
    run_kernel = cfg.use_kernel and cfg.mode == "dual"
    y, counts = spd.matmul(
        x, w, mode=cfg.mode, block_m=cfg.block_m, block_n=cfg.block_n,
        slice_k=cfg.block_k, use_kernel=run_kernel,
        collect_stats=cfg.collect_stats or run_kernel,
        name="dual_sparse_linear")
    if cfg.use_bias:
        y = y + params["b"]
    return y, counts
