"""Norms and positions: the JAX package's ``models/nn.py`` without
the sharding helpers.

Norm parameters are ``nn.ParameterDict``s with a ``scale`` (and, for
layer norm, a ``bias``), mirroring the JAX parameter dicts.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt) + bias.to(dt)


def init_norm(d: int, kind: str = "rms", *, device=None,
              dtype=torch.float32) -> nn.ParameterDict:
    """Scale ones (and, for ``kind="layer"``, bias zeros)."""
    def param(fill):
        return nn.Parameter(torch.full((d,), fill, device=device, dtype=dtype),
                            requires_grad=False)
    p = {"scale": param(1.0)}
    if kind != "rms":
        p["bias"] = param(0.0)
    return nn.ParameterDict(p)


def apply_norm(params: nn.ParameterDict, x: torch.Tensor, eps: float
               ) -> torch.Tensor:
    if "bias" in params:
        return layer_norm(x, params["scale"], params["bias"], eps)
    return rms_norm(x, params["scale"], eps)


def sinusoidal_positions(positions: torch.Tensor, dim: int,
                         dtype=torch.float32) -> torch.Tensor:
    """(...) positions → (..., dim) sinusoidal embeddings: the JAX
    package's float32 formula (sin on even, cos on odd features),
    evaluated at the given positions instead of gathered from a 65536-row
    table, then cast to ``dtype``."""
    pos = positions.to(torch.float32)[..., None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=positions.device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(*positions.shape, dim, dtype=torch.float32,
                     device=positions.device)
    pe[..., 0::2] = torch.sin(pos * div)
    pe[..., 1::2] = torch.cos(pos * div)
    return pe.to(dtype)
