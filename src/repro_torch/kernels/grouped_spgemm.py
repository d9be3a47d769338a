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

The MoE expert FFNs (``models/moe.py``) are the other caller: E experts'
capacity buffers (C rows each, 8-24 at decode) against the stacked expert
weights.  An expert no token was routed to has an all-zero buffer, so all
its blocks have ``counts == 0`` and its weights are never read — the
ragged skip the gating makes without any pruning.  Those bf16 products
(N = 1536-14336) take the tensor-core route.

:func:`grouped_spgemm` and :func:`grouped_spgemm_kfused` are the
on-the-fly entries: they plan the per-problem schedules from the operands
(:func:`plan_grouped`, or element planning), then launch K3 / K4.

``device=None`` means the card; CPU tensors run the plain versions, CUDA
tensors launch the kernel or raise.  ``launches`` on each wrapper counts
kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import bitmap_spgemm as bsk
from repro_torch.sparse import plan as pln


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


# ---------------------------------------------------------------------------
# on-the-fly entries: plan from the operands, then launch
# ---------------------------------------------------------------------------

def plan_grouped(a: torch.Tensor, b: torch.Tensor, block_m: int,
                 block_n: int, slice_k: int = pln.SLICE_K
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's per-problem schedule of ``a (E, C, K) @ b (E, K, N)`` from the
    operands' non-zero masks: (ks (E, Mt, Nt, S), counts (E, Mt, Nt))
    int32, front-packed with repeat-last tails."""
    return pln.plan_operands(a, b, block_m, block_n, slice_k)


def grouped_spgemm(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
                   block_n: int = 128, slice_k: int = pln.SLICE_K,
                   out_dtype: Optional[torch.dtype] = None,
                   device=None) -> torch.Tensor:
    """Ragged grouped SpGEMM with on-the-fly per-problem planning, then
    K3.  Blocks clamp by the one rule of
    :func:`repro_torch.sparse.plan.clamp_geometry` (as
    :func:`~repro_torch.kernels.bitmap_spgemm.bitmap_spgemm` does).
    ``device=None`` means the card."""
    dev, (bm, bn, sk) = bsk.on_the_fly(a, b, block_m, block_n, slice_k,
                                        device, ndim=3)
    ks, counts = plan_grouped(a, b, bm, bn, sk)
    return grouped_spgemm_planned(a.contiguous(), b.contiguous(), ks, counts,
                                  block_m=bm, block_n=bn, slice_k=sk,
                                  out_dtype=out_dtype, device=dev)


def grouped_spgemm_kfused(a: torch.Tensor, b: torch.Tensor, *,
                          block_m: int = 128, block_n: int = 128,
                          slice_k: int = pln.SLICE_K,
                          out_dtype: Optional[torch.dtype] = None,
                          device=None) -> torch.Tensor:
    """Fused-K-condensed grouped SpGEMM: per-problem element planning
    (:func:`repro_torch.sparse.plan.plan_grouped_kcondensed`), then K4.
    ``device=None`` means the card."""
    dev, (bm, bn, sk) = bsk.on_the_fly(a, b, block_m, block_n, slice_k,
                                        device, ndim=3)
    kp = pln.plan_grouped_kcondensed(pln.element_activity_lhs(a, bm),
                                     pln.element_activity_rhs(b, bn), sk)
    return grouped_spgemm_kfused_planned(
        a.contiguous(), b.contiguous(), kp.gk, kp.counts, block_m=bm,
        block_n=bn, slice_k=sk, out_dtype=out_dtype, device=dev)
