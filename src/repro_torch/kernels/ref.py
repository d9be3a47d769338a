"""Oracles for the kernels of this package (the JAX package's
``kernels/ref.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bitmap as bm
from repro_torch.core import im2col as i2c


def spgemm_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """Oracle for K1/K2: a plain matmul with float32 accumulation."""
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return (a.to(torch.float32) @ b.to(torch.float32)).to(out_dtype)


def sparse_im2col_ref(x: torch.Tensor, kh: int, kw: int, stride: int = 1
                      ) -> i2c.LoweredBitmap:
    """Oracle for the im2col chain K5 → K6/K7: the plain bitmap im2col."""
    return i2c.im2col_bitmap(x, kh, kw, stride)


def encode_ref(x: torch.Tensor, slice_k: int = 128):
    """Oracle for K5 on a 2-D x (R, W): (packed bitmap (R, ceil(W/32))
    int32, row-condensed values, per-row non-zeros int32, per-slice
    column activity (R, ceil(W/slice_k)) bool)."""
    mask = x != 0
    k = x.shape[1]
    s = -(-k // slice_k)
    colact = F.pad(mask, (0, s * slice_k - k)).reshape(
        x.shape[0], s, slice_k).any(-1)
    return (bm.pack_bits_padded(mask, axis=1), bm.condense(x, mask, axis=1),
            mask.sum(1, dtype=torch.int32), colact)
