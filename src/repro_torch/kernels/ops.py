"""The implicit bitmap im2col chain over the kernels K5 → K6/K7.

The JAX package's ``kernels/ops.py`` conv half: :func:`sparse_im2col`
lowers an NHWC batch by encoding it (K5) and lowering at stride 1 (K6) or
stride ≥ 2 (K7); :func:`rowpacked_to_flat` turns the kernels' row-packed
bits into the flat-P :class:`~repro_torch.core.im2col.LoweredBitmap` the
planner reads.  The conversion is plain PyTorch, as it is jnp outside
Pallas in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import device as devmod
from repro_torch.core import im2col as i2c
from repro_torch.kernels.bitmap_encode import bitmap_encode
from repro_torch.kernels.sparse_im2col import (sparse_im2col as _k6,
                                               sparse_im2col_strided as _k7)


def rowpacked_to_flat(low_bits: torch.Tensor, low_vals: torch.Tensor,
                      ow: int, p: int) -> i2c.LoweredBitmap:
    """Row-packed (..., KKC, OH, ceil(OW/32)) bits → flat-P
    :class:`~repro_torch.core.im2col.LoweredBitmap`: unpack each output
    row to its OW bits, concatenate to (..., KKC, P), repack.  Values and
    counts do not depend on the layout."""
    mask = bm.unpack_bits(low_bits, axis=-1)[..., :ow]   # (..., KKC, OH, OW)
    flat = mask.reshape(*mask.shape[:-2], p)
    return i2c.LoweredBitmap(bitmap=bm.pack_bits_padded(flat, axis=-1),
                             values=low_vals,
                             counts=flat.sum(-1, dtype=torch.int32))


def sparse_im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1, *,
                  device=None) -> i2c.LoweredBitmap:
    """Implicit bitmap im2col of x (N, H, W, C) or (H, W, C), VALID:
    K5, then K6 (stride 1) or K7 (stride ≥ 2), then the flat-P layout.
    ``device=None`` means the card; on the CPU every step runs its plain
    version."""
    dev = devmod.resolve(device)
    single = x.ndim == 3
    xb = x[None] if single else x
    _, h, w, _ = xb.shape
    oh, ow = i2c.out_size(h, kh, stride), i2c.out_size(w, kw, stride)
    bits, cond = bitmap_encode(xb.permute(0, 3, 1, 2), device=dev)
    if stride == 1:
        low_bits, low_vals = _k6(cond, bits, kh=kh, kw=kw, device=dev)
    else:
        low_bits, low_vals = _k7(cond, bits, kh=kh, kw=kw, stride=stride,
                                 device=dev)
    lb = rowpacked_to_flat(low_bits, low_vals, ow, oh * ow)
    return i2c.LoweredBitmap(*(t[0] for t in lb)) if single else lb
