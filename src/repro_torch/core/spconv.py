"""Dual-side sparse convolution = bitmap implicit im2col + bitmap SpGEMM
(paper §IV), as the JAX package's ``core/spconv.py``.

* :func:`conv2d_ref` — PyTorch's dense convolution (the oracle);
* :func:`conv2d_im2col` — explicit dense im2col + matmul (the paper's
  *Dense Explicit* baseline);
* :func:`conv2d_dual_sparse` — a thin wrapper over
  :func:`repro_torch.sparse.conv.conv2d` in dual mode (*Dual Sparse
  Implicit*), which records its steps on the :mod:`repro_torch.sparse.tape`.

Layouts as in the JAX package: x (N, H, W, C), w (KH, KW, C, F), VALID.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import device as devmod
from repro_torch.core import im2col as i2c
from repro_torch.core import stats


class SpConvResult(NamedTuple):
    out: torch.Tensor          # (N, OH, OW, F)
    steps: stats.StepCounts    # block-skip work units


def conv2d_ref(x: torch.Tensor, w: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """Oracle: x (N, H, W, C), w (KH, KW, C, F) → (N, OH, OW, F), VALID."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride)
    return y.permute(0, 2, 3, 1)


def conv2d_im2col(x: torch.Tensor, w: torch.Tensor,
                  stride: int = 1) -> torch.Tensor:
    """Dense explicit im2col + GEMM, one image at a time (paper
    baseline)."""
    n, h, wd, c = x.shape
    kh, kw, _, f = w.shape
    oh, ow = i2c.out_size(h, kh, stride), i2c.out_size(wd, kw, stride)
    w_flat = w.reshape(kh * kw * c, f)
    out = torch.stack([(w_flat.T @ i2c.im2col_outer(img, kh, kw, stride)).T
                       for img in x])
    return out.reshape(n, oh, ow, f)


def conv2d_dual_sparse(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                       *, block_m: int = 128, block_n: int = 128,
                       block_k: int = 128, use_kernel: bool = False,
                       device=None) -> SpConvResult:
    """Dual-side sparse conv through :func:`repro_torch.sparse.conv.conv2d`
    (``block_k`` is its slice_k).  ``use_kernel`` runs K5 → K6/K7 → K1,
    else the plain reference chain and one matmul.  ``device=None`` means
    the card."""
    from repro_torch.sparse import conv as spc
    devmod.check_all_on(devmod.resolve(device), x=x, w=w)
    out, steps = spc.conv2d(
        x, w, stride, mode="dual", block_m=block_m, block_n=block_n,
        slice_k=block_k, use_kernel=use_kernel, collect_stats=True,
        name="spconv.dual")
    return SpConvResult(out=out, steps=steps)
