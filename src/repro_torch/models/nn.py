"""Norms, positions and the logical-axis context: the JAX package's
``models/nn.py``.

Norm parameters are ``nn.ParameterDict``s with a ``scale`` (and, for
layer norm, a ``bias``), mirroring the JAX parameter dicts.

The launcher installs logical → mesh axis rules with :func:`axis_rules`,
and with a mesh the MoE runs sharded (``moe._moe_shard_map``).  Serving
holds the batch whole on every rank; the sharded train step runs each
rank on its rows of the batch, inside :func:`local_batch`.
:func:`shard_act` returns its input unchanged: the JAX package's
``with_sharding_constraint`` only moves where a value lives, never what
it is, and in the port every rank holds the activations whole.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from repro_torch.distributed.sharding import (_best_divisible,  # noqa: F401
                                              mesh_sizes, spec_from_axes)


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


# ---------------------------------------------------------------------------
# logical-axis rules context
# ---------------------------------------------------------------------------

_RULES: contextvars.ContextVar[Optional[Dict[str, Any]]] = \
    contextvars.ContextVar("logical_axis_rules", default=None)
_AXIS_SIZES: contextvars.ContextVar[Optional[Dict[str, int]]] = \
    contextvars.ContextVar("mesh_axis_sizes", default=None)
_MESH: contextvars.ContextVar[Optional[Any]] = \
    contextvars.ContextVar("mesh", default=None)
_MANUAL: contextvars.ContextVar[bool] = \
    contextvars.ContextVar("shard_map_manual", default=False)
_LOCAL: contextvars.ContextVar[Optional[tuple]] = \
    contextvars.ContextVar("batch_local", default=None)


@contextlib.contextmanager
def axis_rules(rules: Dict[str, Any],
               axis_sizes: Optional[Dict[str, int]] = None,
               mesh: Optional[Any] = None):
    """Install logical → mesh axis rules, e.g. {"batch": "data", ...}.

    ``axis_sizes`` (mesh axis name → size; default the mesh's) makes
    :func:`resolve_spec` divisibility-aware; ``mesh`` (a ``DeviceMesh``)
    runs the MoE sharded over it.
    """
    token = _RULES.set(rules)
    token2 = _AXIS_SIZES.set(axis_sizes if axis_sizes is not None
                             else (mesh_sizes(mesh) if mesh is not None
                                   else None))
    token3 = _MESH.set(mesh)
    try:
        yield
    finally:
        _RULES.reset(token)
        _AXIS_SIZES.reset(token2)
        _MESH.reset(token3)


def resolve_spec(axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None):
    """Logical axis names → PartitionSpec under the current rules (None
    without rules): a mesh axis at most once per spec, and with ``shape``
    the mesh axes that do not divide a dim dropped."""
    rules = _RULES.get()
    if rules is None:
        return None
    sizes = _AXIS_SIZES.get() or {}
    return spec_from_axes(axes, rules, shape if sizes else None,
                          sizes if shape is not None and sizes else None)


@contextlib.contextmanager
def manual_axes():
    """Mark a region as a sharded block's body, where every tensor is the
    rank's own block: :func:`shard_act` is a no-op there (as it is
    everywhere in the port)."""
    token = _MANUAL.set(True)
    try:
        yield
    finally:
        _MANUAL.reset(token)


@contextlib.contextmanager
def local_batch(axes: Sequence[str]):
    """Mark a region whose activations are this rank's rows of the batch,
    the block its coordinates on mesh ``axes`` own (the sharded train
    step: the ``"batch"`` rule's axes that split a microbatch's rows): the
    sharded MoE takes its input as that block and returns its own."""
    token = _LOCAL.set(tuple(axes))
    try:
        yield
    finally:
        _LOCAL.reset(token)


def local_batch_axes() -> Optional[tuple]:
    """The mesh axes of :func:`local_batch` in force (None outside)."""
    return _LOCAL.get()


def current_mesh():
    return _MESH.get()


def current_rules() -> Optional[Dict[str, Any]]:
    return _RULES.get()


def mesh_axis_size(name) -> int:
    """The product of the sizes of mesh axis ``name`` (or a tuple of
    names) under the current rules (1 for None or an unknown axis)."""
    sizes = _AXIS_SIZES.get() or {}
    if name is None:
        return 1
    parts = tuple(name) if isinstance(name, (tuple, list)) else (name,)
    prod = 1
    for p in parts:
        prod *= sizes.get(p, 1)
    return prod


def shard_act(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``x`` unchanged.  The JAX package constrains the activation's
    placement here (``with_sharding_constraint`` under the rules), which
    changes no value; the port keeps activations whole on every rank."""
    return x


def dim_shardable(size: int, logical: str) -> bool:
    """True if ``size`` divides evenly over the mesh axes of ``logical``
    under the current rules (True when no rules are installed)."""
    rules = _RULES.get()
    sizes = _AXIS_SIZES.get()
    if rules is None or sizes is None:
        return True
    m = rules.get(logical)
    if m is None:
        return True
    parts = tuple(m) if isinstance(m, (tuple, list)) else (m,)
    prod = 1
    for p in parts:
        prod *= sizes.get(p, 1)
    return size % prod == 0
