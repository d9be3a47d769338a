"""Public entries of the kernels, as the JAX package's ``kernels/ops.py``.

* :func:`bitmap_encode` encodes one (C, H, W) feature map with K5;
* :func:`sparse_im2col` lowers an NHWC batch by encoding it (K5) and
  lowering at stride 1 (K6) or stride ≥ 2 (K7);
  :func:`rowpacked_to_flat` turns the kernels' row-packed bits into the
  flat-P :class:`~repro_torch.core.im2col.LoweredBitmap` the planner reads
  (plain PyTorch, as it is jnp outside Pallas in the JAX package);
* the SpGEMM entries of :mod:`repro_torch.kernels.bitmap_spgemm` (K1, K2
  and their on-the-fly planning) are re-exported under their names.

K5-K7 are held here under their own names (``_k5``, ``_k6``, ``_k7``),
which a caller may wrap.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import device as devmod
from repro_torch.core import im2col as i2c
from repro_torch.kernels.bitmap_encode import bitmap_encode as _k5
from repro_torch.kernels.bitmap_spgemm import (  # noqa: F401 (re-exports)
    bitmap_spgemm, bitmap_spgemm_kcondensed, bitmap_spgemm_kfused,
    bitmap_spgemm_kfused_planned, bitmap_spgemm_planned, kcondense,
    plan_slices)
from repro_torch.kernels.sparse_im2col import (sparse_im2col as _k6,
                                               sparse_im2col_strided as _k7)


def bitmap_encode(x: torch.Tensor, *, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 on one feature map x (C, H, W) → (bits (C, H, ceil(W/32)) int32,
    row-condensed values (C, H, W)).  ``device=None`` means the card."""
    if x.ndim != 3:
        raise ValueError(f"bitmap_encode takes (C, H, W), got "
                         f"{tuple(x.shape)}")
    bits, cond = _k5(x[None], device=device)
    return bits[0], cond[0]


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
    bits, cond = _k5(xb.permute(0, 3, 1, 2), device=dev)
    if stride == 1:
        low_bits, low_vals = _k6(cond, bits, kh=kh, kw=kw, device=dev)
    else:
        low_bits, low_vals = _k7(cond, bits, kh=kh, kw=kw, stride=stride,
                                 device=dev)
    lb = rowpacked_to_flat(low_bits, low_vals, ow, oh * ow)
    return i2c.LoweredBitmap(*(t[0] for t in lb)) if single else lb
