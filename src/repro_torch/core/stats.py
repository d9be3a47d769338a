"""Machine-independent step counts for dual-side sparse GEMM.

The JAX package's ``core/stats.py``: integer counts, equal to its own.

* :func:`ohmma_steps` — the paper's GPU model: a warp computes a 32×32×1
  outer product per step as 8 OHMMA.8161 instructions (4 A-groups of 8 ×
  2 B-groups of 16, paper Fig. 15).  Condensed non-zero counts quantise
  to ⟨0,25,50,75⟩% skip on the A side and ⟨0,50⟩% on the B side (Fig. 5),
  and empty warp tiles are skipped entirely by the level-2 bitmap (Fig. 9).
  :func:`ohmma_steps_single_side` is the weight-only baseline.
* :func:`mxu_steps` — the kernels' model: the unit of skip is a
  ``slice_k``-deep k-slice inside a (block_m, block_k) × (block_k,
  block_n) block; a fully inactive block is skipped (level 2).
* :func:`im2col_read_cost` — the per-element read cost of im2col
  variants (paper Table III).

Every model counts multiply-accumulate work units; speedup = dense/steps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

# the paper's warp tile (§III-B3, Fig. 5): a 32×32×1 outer product per
# step; one OHMMA covers an 8×16 sub-tile, so 8 OHMMAs a step
WARP_M = 32
WARP_N = 32
OHMMA_M = 8
OHMMA_N = 16
WARP_BITS_PER_READ = 32


class StepCounts(NamedTuple):
    dense: torch.Tensor   # steps the dense schedule would take
    sparse: torch.Tensor  # steps after dual-side skipping
    tiles_skipped: torch.Tensor  # level-2 whole-tile skips

    @property
    def speedup(self) -> torch.Tensor:
        return (torch.as_tensor(self.dense)
                / torch.as_tensor(self.sparse).clamp(min=1))


def _ceil_div(a, b):
    return (a + b - 1) // b


def ohmma_steps(a: torch.Tensor, b: torch.Tensor) -> StepCounts:
    """OHMMA instruction counts for C = A(M,K) @ B(K,N), dual-side sparse.

    For every warp tile (i, j) and k step, A's column fragment (32 rows)
    condenses to ``ca`` non-zeros and B's row fragment (32 columns) to
    ``cb``; the step issues ceil(ca/8) · ceil(cb/16) OHMMAs (dense 4 · 2
    = 8).  Summed over tiles as Σ_k (Σ_i qa[i,k]) (Σ_j qb[j,k]): the same
    integers as the per-tile sum, without the (Mt, Nt, K) product.
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    mt, nt = _ceil_div(m, WARP_M), _ceil_div(n, WARP_N)
    an = F.pad((a != 0).to(torch.int64), (0, 0, 0, mt * WARP_M - m))
    bn = F.pad((b != 0).to(torch.int64), (0, nt * WARP_N - n))
    ca = an.reshape(mt, WARP_M, k).sum(1)                        # (Mt, K)
    cb = bn.reshape(k, nt, WARP_N).sum(2).T                      # (Nt, K)
    qa = _ceil_div(ca, OHMMA_M)                                  # 0..4
    qb = _ceil_div(cb, OHMMA_N)                                  # 0..2
    steps = (qa.sum(0) * qb.sum(0)).sum()
    dense = torch.tensor(mt * nt * k * (WARP_M // OHMMA_M)
                         * (WARP_N // OHMMA_N))
    # level-2 skips: (i, j, k) steps with qa · qb == 0
    skipped = (mt * nt - (qa > 0).sum(0) * (qb > 0).sum(0)).sum()
    return StepCounts(dense=dense, sparse=steps, tiles_skipped=skipped)


def ohmma_steps_single_side(b: torch.Tensor, m: int) -> StepCounts:
    """The single-side model of Sparse Tensor Core [72]: only the weight
    matrix B (K, N) is sparse; A (m rows) is dense."""
    k, n = b.shape
    nt, mt = _ceil_div(n, WARP_N), _ceil_div(m, WARP_M)
    bn = F.pad((b != 0).to(torch.int64), (0, nt * WARP_N - n))
    cb = bn.reshape(k, nt, WARP_N).sum(2).T
    qb = _ceil_div(cb, OHMMA_N)
    qa = WARP_M // OHMMA_M                                       # dense: 4
    steps = (qa * qb).sum() * mt
    dense = torch.tensor(mt * nt * k * 8)
    return StepCounts(dense=dense, sparse=steps,
                      tiles_skipped=(qb == 0).sum() * mt)


def mxu_steps(a: torch.Tensor, b: torch.Tensor, block_m: int = 256,
              block_n: int = 256, block_k: int = 256,
              slice_k: int = 128) -> StepCounts:
    """Work units of the block-skip kernel: one (block_m × slice_k) ×
    (slice_k × block_n) product.  A k-slice of block (i, j, kb) is active
    iff some column of the A block uses it AND some row of the B block
    does; sparse units are the active slices over (i, j, kb), and a block
    with none is skipped (level 2)."""
    m, k = a.shape
    _, n = b.shape
    slice_k = min(slice_k, block_k)
    mt, nt = _ceil_div(m, block_m), _ceil_div(n, block_n)
    kt = _ceil_div(k, block_k)
    an = F.pad(a != 0, (0, kt * block_k - k, 0, mt * block_m - m))
    bn = F.pad(b != 0, (0, nt * block_n - n, 0, kt * block_k - k))
    s = block_k // slice_k
    col = an.reshape(mt, block_m, kt, s, slice_k).any(4).any(1)  # (Mt,Kt,s)
    row = bn.reshape(kt, s, slice_k, nt, block_n).any(4).any(2)  # (Kt,s,Nt)
    act = col[:, None] & row.permute(2, 0, 1)[None]        # (Mt,Nt,Kt,s)
    return StepCounts(dense=torch.tensor(mt * nt * kt * s),
                      sparse=act.sum(),
                      tiles_skipped=(~act.any(-1)).sum())


def im2col_read_cost(density: float, kind: str) -> float:
    """Relative per-output-element read cost of im2col variants (paper
    Table III): CSR pays two data-dependent index reads per non-zero;
    a bitmap one bit (1/32 of a word read) plus a popcount; dense reads
    everything once.  Constants, not measured cycles."""
    if kind == "dense":
        return 1.0
    if kind == "csr":
        return density * 3.0 + 0.05
    if kind == "bitmap":
        return density * 1.0 + 1.0 / WARP_BITS_PER_READ
    raise ValueError(kind)
