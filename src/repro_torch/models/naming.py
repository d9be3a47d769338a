"""The port's parameter names against the JAX package's tree.

The port names one tensor per layer (``layers.5.attn.wq``); the JAX tree
stacks each period position's layers on a leading axis
(``layers.pos{p}``, the encoder's ``enc_layers.pos0``), so a layer's
parameter is a slice of a stacked leaf, whose rank is one more.  The
optimizer, the train step and gradient compression read a leaf's rank or
its rows by these rules.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

STACKS = ("layers", "enc_layers")


def stacked_leaf(name: str, period: int) -> Tuple[str, Optional[int]]:
    """The JAX leaf that holds port parameter ``name`` and its index on the
    leaf's stacking axis (None for an unstacked leaf): layer i of the
    decoder is ``layers.pos{i % period}`` at i // period, layer i of the
    encoder (period 1) ``enc_layers.pos0`` at i; e.g.
    ``layers.5.attn.wq`` with period 2 → (``layers.pos1.attn.wq``, 2)."""
    head, _, rest = name.partition(".")
    if head not in STACKS:
        return name, None
    i, _, leaf = rest.partition(".")
    p = period if head == "layers" else 1
    return f"{head}.pos{int(i) % p}.{leaf}", int(i) // p


def is_layer_param(name: str) -> bool:
    """Whether port parameter ``name`` is a layer's, a slice of a JAX leaf
    stacked over the layers."""
    return name.partition(".")[0] in STACKS


def jax_ndim(name: str, t: torch.Tensor) -> int:
    """The rank of ``name``'s leaf in the JAX tree: one more than the
    port's for a layer's parameter."""
    return t.ndim + is_layer_param(name)
