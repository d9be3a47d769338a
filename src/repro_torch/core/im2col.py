"""im2col variants (paper §IV): dense, outer-product-friendly, CSR and
bitmap-sparse.

Conventions as in the JAX package's ``core/im2col.py``: feature maps are
NHWC; for a (KH, KW) kernel at stride S with VALID padding, lowered row
``k = (dy, dx, c)`` (``(dy·KW + dx)·C + c``) is channel c sampled at
offset (dy, dx) over the P = OH·OW output positions.
:func:`im2col_dense` is the inner-product layout (P, KH·KW·C) and
:func:`im2col_outer` its transpose L^T, the outer-product layout (paper
Fig. 10b); :func:`im2col_csr` lowers through a CSR encoding, the
comparison baseline of paper Table III.  The bitmap lowering is carried
as a :class:`LoweredBitmap` — packed bitmap, row-condensed values and
counts — and never exists dense.  :func:`im2col_bitmap` is the plain
reference of the whole encode → im2col chain (the JAX package's
``im2col_bitmap``), over an optional leading image axis;
:func:`lower_rows` is its lowering step, which the plain versions of the
im2col kernels K6/K7 share.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import bitmap as bm


def out_size(h: int, k: int, s: int) -> int:
    return (h - k) // s + 1


# ---------------------------------------------------------------------------
# dense im2col (inner- and outer-product layouts)
# ---------------------------------------------------------------------------

def extract_patches(x: torch.Tensor, kh: int, kw: int,
                    stride: int) -> torch.Tensor:
    """x (H, W, C) → patches (OH, OW, KH, KW, C), VALID padding."""
    h, w, _ = x.shape
    oh, ow = out_size(h, kh, stride), out_size(w, kw, stride)
    ar = lambda n: torch.arange(n, device=x.device)  # noqa: E731
    rows = ar(oh)[:, None] * stride + ar(kh)[None, :]
    cols = ar(ow)[:, None] * stride + ar(kw)[None, :]
    return x[rows[:, None, :, None], cols[None, :, None, :], :]


def im2col_dense(x: torch.Tensor, kh: int, kw: int,
                 stride: int) -> torch.Tensor:
    """Inner-product layout of the lowered map: (P, KH·KW·C)."""
    p = extract_patches(x, kh, kw, stride)
    oh, ow, _, _, c = p.shape
    return p.reshape(oh * ow, kh * kw * c)


def im2col_outer(x: torch.Tensor, kh: int, kw: int,
                 stride: int) -> torch.Tensor:
    """Outer-product layout L^T (KH·KW·C, P): row (dy, dx, c) is channel c
    sampled at offset (dy, dx) over every output position — the order the
    column-at-a-time zig-zag of paper Fig. 10b lands rows in."""
    p = extract_patches(x, kh, kw, stride)
    oh, ow, _, _, c = p.shape
    return p.permute(2, 3, 4, 0, 1).reshape(kh * kw * c, oh * ow)


# ---------------------------------------------------------------------------
# bitmap sparse im2col (paper Fig. 11)
# ---------------------------------------------------------------------------

class LoweredBitmap(NamedTuple):
    """Lowered feature map in condensed bitmap encoding.

    bitmap : (..., KKC, ceil(P/32)) int32 bit patterns over the flat P axis.
    values : (..., KKC, P) row-condensed non-zeros, zero tail.
    counts : (..., KKC) int32 non-zeros per lowered row.
    """
    bitmap: torch.Tensor
    values: torch.Tensor
    counts: torch.Tensor


def lowered_indices(c: int, h: int, w: int, kh: int, kw: int, stride: int,
                    device=None):
    """Broadcastable (channel, row, column) source indices of the lowered
    map, shaped (KH, KW, C, OH, OW): lowered row (dy, dx, ch), output
    position (oy, ox) reads pixel (ch, oy·S + dy, ox·S + dx)."""
    oh, ow = out_size(h, kh, stride), out_size(w, kw, stride)
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    ys = ar(kh)[:, None] + ar(oh)[None, :] * stride        # (KH, OH)
    xs = ar(kw)[:, None] + ar(ow)[None, :] * stride        # (KW, OW)
    return (ar(c)[None, None, :, None, None], ys[:, None, None, :, None],
            xs[None, :, None, None, :])


def lower_rows(mask: torch.Tensor, cond: torch.Tensor, kh: int, kw: int,
               stride: int):
    """Lower encoded feature maps: mask (B, C, H, W) bool and the rows'
    condensed values cond (B, C, H, W) → (bits (B, KKC, OH, OW) bool,
    values (B, KKC, P) condensed per lowered row).

    S2 takes each lowered bit from its row's mask; S3 the exclusive
    popcount prefix of the row is the offset into its condensed values;
    S4 gathers them and condenses each lowered row.
    """
    b, c, h, w = mask.shape
    oh, ow = out_size(h, kh, stride), out_size(w, kw, stride)
    cum = torch.cumsum(mask, -1) - mask.to(torch.int64)  # exclusive prefix
    ib = torch.arange(b, device=mask.device)[:, None, None, None, None,
                                             None]
    ic, iy, ix = lowered_indices(c, h, w, kh, kw, stride, mask.device)
    bits = mask[ib, ic, iy, ix]                          # (B,KH,KW,C,OH,OW)
    vals = cond[ib, ic, iy, cum[ib, ic, iy, ix]]
    vals = torch.where(bits, vals, torch.zeros_like(vals))
    kkc = kh * kw * c
    flat = bits.reshape(b, kkc, oh * ow)
    return (bits.reshape(b, kkc, oh, ow),
            bm.condense(vals.reshape(b, kkc, oh * ow), flat, axis=-1))


def im2col_bitmap(x: torch.Tensor, kh: int, kw: int, stride: int
                  ) -> LoweredBitmap:
    """Bitmap sparse im2col of x (H, W, C) or (N, H, W, C): S0 encodes
    each feature-map row (bitmap + condensed values), then
    :func:`lower_rows`; the bitmap is packed over the flat P axis."""
    xc = torch.movedim(x, -1, -3)                        # (..., C, H, W)
    *lead, c, h, w = xc.shape
    xc = xc.reshape(-1, c, h, w)
    mask = xc != 0
    bits, vals = lower_rows(mask, bm.condense(xc, mask, axis=-1), kh, kw,
                            stride)
    flat = bits.reshape(*lead, bits.shape[1], -1)
    return LoweredBitmap(
        bitmap=bm.pack_bits_padded(flat, axis=-1),
        values=vals.reshape(flat.shape),
        counts=flat.sum(-1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# CSR im2col (comparison baseline of paper Table III)
# ---------------------------------------------------------------------------

class CSRMatrix(NamedTuple):
    data: torch.Tensor      # (R*C,) non-zeros first, zero tail
    indices: torch.Tensor   # (R*C,) int32 column of each non-zero
    indptr: torch.Tensor    # (R+1,) int32
    shape: Tuple[int, int]


def csr_encode(x: torch.Tensor) -> CSRMatrix:
    """Dense (R, C) → CSR at capacity R·C (the JAX package's static
    shapes): the non-zeros in row-major order, then a zero tail."""
    r, c = x.shape
    flat = x.reshape(-1)
    nz = torch.nonzero(flat != 0).reshape(-1)
    data = torch.zeros_like(flat)
    data[:nz.numel()] = flat[nz]
    indices = torch.zeros(r * c, dtype=torch.int32, device=x.device)
    indices[:nz.numel()] = (nz % c).to(torch.int32)
    indptr = torch.zeros(r + 1, dtype=torch.int32, device=x.device)
    indptr[1:] = torch.cumsum((x != 0).sum(1), 0)
    return CSRMatrix(data=data, indices=indices, indptr=indptr, shape=(r, c))


def im2col_csr(x: torch.Tensor, kh: int, kw: int,
               stride: int) -> torch.Tensor:
    """CSR im2col: rebuild each row of x (H, W, C) through indptr/indices
    (two data-dependent reads a non-zero, the cost Table III counts), then
    lower; returns the dense L^T."""
    h, w, c = x.shape
    csr = csr_encode(x.reshape(h, w * c))
    nnz = int(csr.indptr[-1])
    rows = torch.searchsorted(
        csr.indptr, torch.arange(nnz, dtype=torch.int32, device=x.device),
        right=True) - 1
    dense = torch.zeros((h, w * c), dtype=x.dtype, device=x.device)
    dense[rows, csr.indices[:nnz].to(torch.int64)] = csr.data[:nnz]
    return im2col_outer(dense.reshape(h, w, c), kh, kw, stride)
