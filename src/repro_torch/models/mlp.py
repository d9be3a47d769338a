"""MLP blocks: squared-ReLU / ReLU / GeLU (+ the dual-sparse path).

Squared-ReLU (nemotron) produces genuine activation zeros, which is where
dual-side SpGEMM applies at inference; GeLU (whisper, the tanh form of
``jax.nn.gelu``) is dense, and its down projection plans from the values.
With ``cfg.sparse_mode != "dense"`` both projections route through
:mod:`repro_torch.sparse`: a ReLU-family activation is a
:class:`~repro_torch.sparse.activation.SparseActivation` whose bitmap is
made once, at activation time, and read by the down-projection's
planner.  ``MLP.forward`` is the JAX package's ``mlp_forward``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.sparse import activation as act
from repro_torch.sparse import plan as pln
from repro_torch.sparse import site
from repro_torch.sparse.weights import planned_or_array

_KINDS = ("relu", "relu2", "gelu")


def _activate(h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return act.gelu(h)
    r = torch.clamp(h, min=0)
    return r * r if kind == "relu2" else r


class MLP(nn.Module):
    """w_up (d, f) and w_down (f, d), the JAX layouts."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        if cfg.mlp_type not in _KINDS:
            raise ValueError(f"mlp_type {cfg.mlp_type!r} is not ported; "
                             f"have {_KINDS}")
        d, f = cfg.d_model, cfg.d_ff
        self.w_up = nn.Parameter(torch.empty(d, f, device=device,
                                             dtype=dtype), requires_grad=False)
        self.w_down = nn.Parameter(torch.empty(f, d, device=device,
                                               dtype=dtype),
                                   requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, f = self.w_up.shape
        self.w_up.normal_(0.0, d ** -0.5, generator=generator)
        self.w_down.normal_(0.0, f ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                plans: Optional[Dict] = None) -> torch.Tensor:
        if cfg.sparse_mode == "dense":
            h = _activate(x @ self.w_up.to(x.dtype), cfg.mlp_type)
            return h @ self.w_down.to(x.dtype)
        # element-granular plans ("@elem") attach only under kcondense
        ebn = cfg.sparse_block_n if cfg.sparse_kcondense else 0
        up = site.make("matmul", "mlp.up", axes=("embed", "mlp"))
        down = site.make("matmul", "mlp.down", axes=("mlp", "embed"))
        h, _ = site.matmul(
            x, planned_or_array(self.w_up, plans, "w_up", x.dtype,
                                cfg.sparse_slice_k, block_n=ebn, site=up),
            up, cfg)
        h = act.activate(h, cfg.mlp_type, slice_k=pln.effective_slice_k(
            h.shape[-1], cfg.sparse_slice_k))
        y, _ = site.matmul(
            h, planned_or_array(self.w_down, plans, "w_down", x.dtype,
                                cfg.sparse_slice_k, block_n=ebn, site=down),
            down, cfg)
        return y
