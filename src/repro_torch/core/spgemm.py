"""Outer-product bitmap SpGEMM (paper §III), as the JAX package's
``core/spgemm.py``.

Three levels, lowest first:

* :func:`outer_step` / :func:`merge_partial` — the paper's three primitive
  operations (*multiply-value*, *multiply-bitmap*, *merge* by
  gather–accumulate–scatter, Fig. 2c / Fig. 7);
* :func:`spgemm_emulate` — a K-step loop of outer products over
  bitmap-encoded operands, the warp-level SpGEMM of Fig. 5; O(M·N·K), for
  validation at small sizes on the CPU;
* :func:`spgemm` — the production path: the block-skip step counts
  (:func:`repro_torch.core.stats.mxu_steps`) and the product, by K1 with
  on-the-fly planning or by one ``torch.matmul``.

Every path computes ``A @ B`` for any sparsity pattern; sparsity changes
the work schedule, never the result.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import device as devmod
from repro_torch.core import stats


class PartialMatrix(NamedTuple):
    """One outer-product partial matrix D_k in bitmap encoding."""
    values: torch.Tensor   # (M, N) values of a ⊗ b, positionally laid out
    bitmap: torch.Tensor   # (M, N//32) packed int32 — multiply-bitmap


def outer_step(a_col: torch.Tensor, b_row: torch.Tensor,
               a_bits: torch.Tensor, b_bits: torch.Tensor) -> PartialMatrix:
    """*multiply-value* + *multiply-bitmap* for one k step: a_col (M,),
    b_row (N,), their packed bitmaps a_bits (M//32,), b_bits (N//32,)."""
    return PartialMatrix(values=a_col[:, None] * b_row[None, :],
                         bitmap=bm.bitmap_outer(a_bits, b_bits))


def merge_partial(acc: torch.Tensor, part: PartialMatrix) -> torch.Tensor:
    """*merge* (paper Fig. 7): ① gather the accumulator at the partial
    matrix's non-zero positions, ② add the multiply-value output, ③
    scatter back.  With a dense tile-local accumulator the three fuse into
    a masked add."""
    mask = bm.unpack_bits(part.bitmap, axis=1)
    zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
    gathered = torch.where(mask, acc, zero)                       # ①
    accumulated = gathered + torch.where(mask, part.values,
                                         zero.to(part.values.dtype))  # ②
    return torch.where(mask, accumulated, acc)                    # ③


def spgemm_emulate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K-step outer-product SpGEMM over bitmap-encoded operands (Fig. 2c):
    A encoded column-major, B row-major, then K steps of
    :func:`outer_step` + :func:`merge_partial` into a float32 (or wider)
    accumulator.  M and N must be multiples of 32."""
    (m, k), n = a.shape, b.shape[1]
    a_enc, b_enc = bm.encode(a, "col"), bm.encode(b, "row")
    a_dense, b_dense = bm.decode(a_enc), bm.decode(b_enc)
    acc = torch.zeros((m, n), dtype=torch.promote_types(a.dtype,
                                                        torch.float32),
                      device=a.device)
    for kk in range(k):
        acc = merge_partial(acc, outer_step(
            a_dense[:, kk], b_dense[kk, :], a_enc.bitmap[:, kk],
            b_enc.bitmap[kk, :]))
    return acc.to(torch.promote_types(a.dtype, b.dtype))


class SpGEMMResult(NamedTuple):
    out: torch.Tensor
    steps: stats.StepCounts


def plan_blocks(a_tiles: torch.Tensor, b_tiles: torch.Tensor,
                max_active: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block-level skip list from level-2 tile bitmaps a_tiles
    (Mt, Kt) and b_tiles (Kt, Nt): (indices (Mt, Nt, Kt or max_active)
    int32, the active k-blocks of each output block front-packed with a
    repeat-last tail; counts (Mt, Nt) int32)."""
    from repro_torch.sparse import plan as pln
    idx, counts = pln.front_pack(bm.tile_activity_outer(a_tiles, b_tiles))
    if max_active is not None:
        idx = idx[..., :int(max_active)]
    return idx, counts


def spgemm(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
           block_n: int = 256, block_k: int = 256, use_kernel: bool = True,
           device=None) -> SpGEMMResult:
    """Dual-side sparse ``a @ b`` with two-level bitmap block skipping.

    Returns the product and its block-skip step counts
    (:func:`repro_torch.core.stats.mxu_steps` at these blocks, 128-deep
    slices).  ``use_kernel`` runs K1 on a schedule planned from the
    operands (:func:`repro_torch.kernels.bitmap_spgemm.bitmap_spgemm`, its
    plain walk for CPU tensors); otherwise one ``torch.matmul``, as the
    JAX package's ``jnp.dot``.  ``device=None`` means the card.
    """
    dev = devmod.resolve(device)
    devmod.check_all_on(dev, a=a, b=b)
    steps = stats.mxu_steps(a, b, block_m, block_n, block_k)
    if use_kernel:
        from repro_torch.kernels import bitmap_spgemm as bsk
        out = bsk.bitmap_spgemm(a, b, block_m=block_m, block_n=block_n,
                                block_k=block_k, device=dev)
    else:
        out = torch.matmul(a, b)
    return SpGEMMResult(out=out, steps=steps)
