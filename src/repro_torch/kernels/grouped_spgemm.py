"""K3 and K4: the ragged grouped dual-side sparse GEMM kernels, their
wrappers and their plain versions.

* K3, :func:`grouped_spgemm_planned` — replaces the JAX package's TPU
  kernel ``kernels/grouped_spgemm.py::grouped_spgemm_planned``
  (``_grouped_kernel``).  ``C[e] = A[e] @ B[e]`` for E stacked problems;
  block (e, i, j) visits only its front-packed active k-slices
  ``ks[e, i, j, :counts[e, i, j]]``, accumulating in float32.
* K4, :func:`grouped_spgemm_kfused_planned` — replaces
  ``kernels/grouped_spgemm.py::grouped_spgemm_kfused_planned``
  (``_grouped_kfused_kernel``): K2 per problem, step t gathering the
  ``slice_k`` positions ``gk[e, i, j, t, :]``.

Raggedness needs no special case: a problem with fewer occupied rows has
more ``counts == 0`` blocks, which load nothing and store zeros (the TPU
kernel flushes its zero accumulator the same way).  On the served path
the problems are the decode attention's E = batch × KV-head products
(``attention.attend_sparse``): the score ``K[e] @ q[e]ᵀ`` with cache
slots as block-rows and the value ``p[e] @ V[e]`` with slots as the
contraction.  Both do about 2·G flops per byte (G query heads per KV
head), so bytes bound them on the H100; the schedules skip the bytes of
unscheduled cache blocks.  The wrapper picks the CUDA kernel by rule
(:func:`~repro_torch.kernels.bitmap_spgemm.route`): the served bf16 score
(N = G = 12) takes the narrow-N tensor-core kernel of
``csrc/spgemm_grouped.cuh``, one warp a tile of cache slots; the served
value, float32 p against V as stored in bf16, its mixed kernel, which
reads V as bf16 and multiplies in float32; other bf16 products K1/K2's
tensor-core kernel (``csrc/spgemm_mma.cuh``, split schedules), and
float32 ones the SIMT tile kernel (``csrc/spgemm_tile.cuh``), each with
the problem index folded into its grid.

``device=None`` means the card; CPU tensors run the plain versions, CUDA
tensors launch the kernel or raise.  ``launches`` on each wrapper counts
kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import bitmap_spgemm as bsk


def grouped_spgemm_planned_plain(a, b, ks, counts, **kw) -> torch.Tensor:
    """K3's plain version: the slice walk over every problem."""
    return bsk.walk_slices(a, b, ks, counts, **kw)


def grouped_spgemm_kfused_planned_plain(a, b, gk, counts,
                                        **kw) -> torch.Tensor:
    """K4's plain version: the gather walk over every problem."""
    return bsk.walk_gathers(a, b, gk, counts, **kw)


def grouped_spgemm_planned(a: torch.Tensor, b: torch.Tensor,
                           ks: torch.Tensor, counts: torch.Tensor, *,
                           block_m: int = 128, block_n: int = 128,
                           slice_k: int = 128,
                           out_dtype: Optional[torch.dtype] = None,
                           device=None) -> torch.Tensor:
    """K3: ``a[e] @ b[e]`` for a (E, C, K), b (E, K, N) over the schedule
    ks (E, Mt, Nt, S) / counts (E, Mt, Nt).  ``a`` and ``b`` share a type
    (float32 or bf16), or ``a`` is float32 and ``b`` bf16.  Returns
    (E, C, N) in ``out_dtype`` (default: the promoted input dtype)."""
    out = bsk.run("grouped_spgemm.cu", grouped_spgemm_planned_plain, a, b,
                  ks, counts, kfused=False, block_m=block_m,
                  block_n=block_n, slice_k=slice_k, out_dtype=out_dtype,
                  device=device)
    if out.is_cuda:
        grouped_spgemm_planned.launches += 1
    return out


def grouped_spgemm_kfused_planned(a: torch.Tensor, b: torch.Tensor,
                                  gk: torch.Tensor, counts: torch.Tensor, *,
                                  block_m: int = 128, block_n: int = 128,
                                  slice_k: int = 128,
                                  out_dtype: Optional[torch.dtype] = None,
                                  device=None) -> torch.Tensor:
    """K4: ``a[e] @ b[e]`` over the element-condensed schedule
    gk (E, Mt, Nt, S, slice_k) / counts (E, Mt, Nt)."""
    out = bsk.run("grouped_spgemm_kfused.cu",
                  grouped_spgemm_kfused_planned_plain, a, b, gk, counts,
                  kfused=True, block_m=block_m, block_n=block_n,
                  slice_k=slice_k, out_dtype=out_dtype, device=device)
    if out.is_cuda:
        grouped_spgemm_kfused_planned.launches += 1
    return out


grouped_spgemm_planned.launches = 0
grouped_spgemm_kfused_planned.launches = 0
