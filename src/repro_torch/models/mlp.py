"""MLP blocks: SwiGLU / squared-ReLU / ReLU / GeLU (+ the dual-sparse path).

Squared-ReLU (nemotron) produces genuine activation zeros, which is where
dual-side SpGEMM applies at inference; GeLU (whisper, the tanh form of
``jax.nn.gelu``) and SwiGLU (``silu(x @ w_gate) * (x @ w_up)``, the MoE
families' experts and MLPs) are dense, and their down projections plan
from the values.
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

_KINDS = ("swiglu", "relu", "relu2", "gelu")


def _activate(h: torch.Tensor, gate: Optional[torch.Tensor],
              kind: str) -> torch.Tensor:
    """The dense-path activation (the JAX package's ``_activate``)."""
    if kind == "swiglu":
        return torch.nn.functional.silu(gate) * h
    if kind == "gelu":
        return act.gelu(h)
    if kind not in ("relu", "relu2"):
        raise ValueError(kind)
    r = torch.clamp(h, min=0)
    return r * r if kind == "relu2" else r


class MLP(nn.Module):
    """w_up (d, f), w_down (f, d) and, for SwiGLU, w_gate (d, f): the JAX
    layouts."""

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
        self.w_gate = (nn.Parameter(torch.empty(d, f, device=device,
                                                dtype=dtype),
                                    requires_grad=False)
                       if cfg.mlp_type == "swiglu" else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, f = self.w_up.shape
        self.w_up.normal_(0.0, d ** -0.5, generator=generator)
        self.w_down.normal_(0.0, f ** -0.5, generator=generator)
        if self.w_gate is not None:
            self.w_gate.normal_(0.0, d ** -0.5, generator=generator)

    def weights(self) -> Dict[str, torch.Tensor]:
        """The projection weights by their JAX keys."""
        w = {"w_up": self.w_up, "w_down": self.w_down}
        if self.w_gate is not None:
            w["w_gate"] = self.w_gate
        return w

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                plans: Optional[Dict] = None) -> torch.Tensor:
        if cfg.sparse_mode == "dense":
            h = x @ self.w_up.to(x.dtype)
            gate = (x @ self.w_gate.to(x.dtype)
                    if self.w_gate is not None else None)
            return _activate(h, gate, cfg.mlp_type) @ self.w_down.to(x.dtype)
        # element-granular plans ("@elem") attach only under kcondense
        ebn = cfg.sparse_block_n if cfg.sparse_kcondense else 0

        def project(h, key, name, axes):
            st = site.make("matmul", name, axes=axes)
            y, _ = site.matmul(
                h, planned_or_array(getattr(self, key), plans, key, x.dtype,
                                    cfg.sparse_slice_k, block_n=ebn,
                                    site=st),
                st, cfg)
            return y

        h = project(x, "w_up", "mlp.up", ("embed", "mlp"))
        gate = (project(x, "w_gate", "mlp.gate", ("embed", "mlp"))
                if self.w_gate is not None else None)
        h = act.activate(h, cfg.mlp_type, slice_k=pln.effective_slice_k(
            h.shape[-1], cfg.sparse_slice_k), gate=gate)
        return project(h, "w_down", "mlp.down", ("mlp", "embed"))


def mlp_activation_sparsity(params: Dict[str, torch.Tensor], x: torch.Tensor,
                            cfg: ModelConfig) -> torch.Tensor:
    """Fraction of zeros in the post-activation tensor (the dual-side
    input), a 0-d float32 tensor; ``params`` is an :class:`MLP`'s
    :meth:`~MLP.weights`."""
    h = x @ params["w_up"].to(x.dtype)
    gate = (x @ params["w_gate"].to(x.dtype) if "w_gate" in params
            else None)
    h = _activate(h, gate, cfg.mlp_type)
    return (h == 0.0).to(torch.float32).mean()
