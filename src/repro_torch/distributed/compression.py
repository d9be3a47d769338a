"""Gradient compression with error feedback (cross-pod DP traffic): the
JAX package's ``distributed/compression.py``.

int8 symmetric quantisation with one scale per row of the JAX package's
leaf, plus an error feedback accumulator (Seide et al.; 1-bit Adam
lineage): the quantisation residual is carried to the next step, so
compression introduces no bias in the long run.  The JAX package scales
each leading row of a leaf, and a layer's leaf is stacked ``(layers,
...)``, so one of its rows is a whole layer: a layer's parameter here (a
name under ``layers.`` or ``enc_layers.``,
:func:`~repro_torch.models.naming.is_layer_param`) takes one scale
over its whole tensor, and a top-level leaf (``embed``, ``lm_head``, the
final norm) one per leading row.  The transform runs on the accumulated
gradients, a dict of tensors keyed by parameter name.  On a mesh each
tensor is the rank's block under its spec, and a row's absmax is reduced
with a max over every mesh axis that splits the row's extent (for a
layer's tensor, every axis its spec names).  Codes round half to even,
as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import spec_axes
from repro_torch.models.naming import is_layer_param

Tensors = Dict[str, torch.Tensor]


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1) if x.ndim > 1 else x.reshape(1, -1)


def _quantize(flat: torch.Tensor, group=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 (rows, 1) scales) of a (rows, n) tensor, each
    row's absmax taken over ``group`` too (a max ``all_reduce``)."""
    amax = comm.all_reduce(flat.abs().amax(-1, keepdim=True), group, "max")
    # divided by tensors, not Python numbers: CUDA multiplies by the
    # reciprocal of a number, one rounding off the quotient at times
    scale = torch.clamp(amax / flat.new_tensor(127.0), min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of ``x`` (its shape) and float32 scales (rows,
    1), one per leading row: absmax / 127, at least 1e-12."""
    q, scale = _quantize(_rows(x))
    return q.reshape(x.shape), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape
                    ) -> torch.Tensor:
    return (_rows(q).to(torch.float32) * scale).reshape(shape)


def init_error_feedback(grads: Tensors) -> Tensors:
    return {n: torch.zeros_like(g) for n, g in grads.items()}


def _row_axes(name: str, spec) -> Tuple[str, ...]:
    """The mesh axes that split a row of ``name``'s JAX leaf: every axis
    of a layer's spec or of a 1-D leaf's, those past the leading dim of a
    top-level leaf's."""
    whole = is_layer_param(name) or len(spec) < 2
    return spec_axes(tuple(spec) if whole else tuple(spec)[1:])


def ef_compress(grads: Tensors, ef: Tensors, *, specs: Optional[Dict] = None,
                mesh=None) -> Tuple[Tensors, Tensors]:
    """Error-feedback compression round trip: (the decompressed gradients
    to apply, the new error-feedback state), g' = Q(g + e) and
    e_new = (g + e) - g', a scale per row of each JAX leaf.  With
    ``mesh``, ``grads`` and ``ef`` are the rank's blocks under ``specs``
    and each row's scale is the whole row's."""
    out, new_ef = {}, {}
    for n, g in grads.items():
        target = g.to(torch.float32) + ef[n]
        flat = target.reshape(1, -1) if is_layer_param(n) else _rows(target)
        group = None
        if mesh is not None:
            axes = _row_axes(n, specs[n])
            group = comm.axis_group(mesh, axes) if axes else None
        q, s = _quantize(flat, group)
        deq = (q.to(torch.float32) * s).reshape(g.shape)
        out[n], new_ef[n] = deq.to(g.dtype), target - deq
    return out, new_ef


def compressed_bytes(grads: Tensors) -> int:
    """Wire bytes of the int8 payload (against 4 a value for float32):
    the codes and a float32 scale per row of each JAX leaf, so a stack's
    layers sum to the JAX package's count for their leaf."""
    return sum(g.numel() + 4 * (1 if is_layer_param(n) or g.ndim < 2
                                else g.shape[0])
               for n, g in grads.items())
