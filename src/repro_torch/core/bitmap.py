"""Bitmap sparse encoding (paper §III-A, Fig. 2b / Fig. 9).

A sparse matrix is a two-tuple *(bitmap, condensed values)*: the bitmap
holds 1-bits at non-zero positions and the values are the non-zeros
pushed along the contraction-friendly axis — column-major for the left
operand A, row-major for the right operand B (paper Fig. 4c).  The
two-level variant (Fig. 9) adds a tile bitmap with one bit per
(tile_m × tile_k) tile, so empty tiles are skipped wholesale.  As in the
JAX package, condensed buffers keep full capacity with a zero tail: the
counts and bitmaps carry the savings.

Bitmaps are packed 32 positions per word, LSB-first: bit i of word w is
position w*32+i — the JAX package's layout.  PyTorch on the CPU has no
shifts for ``uint32``, so words are carried as int32 *bit patterns*:
``words.numpy().view(np.uint32)`` equals the JAX package's uint32 words.
Shifts run on int64 copies.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

WORD = 32  # bits per packed bitmap word
_U32 = 1 << 32


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD, dtype=torch.int64, device=device)


def pack_bits(mask: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a boolean mask into int32 bit-pattern words along ``axis``.

    The axis length must be a multiple of 32.
    """
    mask = torch.movedim(mask, axis, -1)
    *lead, n = mask.shape
    if n % WORD:
        raise ValueError(f"bitmap axis ({n}) must be a multiple of {WORD}")
    m = mask.reshape(*lead, n // WORD, WORD).to(torch.int64)
    words = (m << _shifts(mask.device)).sum(-1)        # [0, 2**32)
    words = torch.where(words >= _U32 // 2, words - _U32, words)
    return torch.movedim(words.to(torch.int32), -1, axis)


def pack_bits_padded(mask: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """:func:`pack_bits` with the axis zero-padded to a WORD multiple."""
    mask = torch.movedim(mask, axis, -1)
    pad = (-mask.shape[-1]) % WORD
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    return torch.movedim(pack_bits(mask, axis=-1), -1, axis)


def _bits(words: torch.Tensor) -> torch.Tensor:
    """(..., nw) int32 words → (..., nw, 32) int64 0/1 bits."""
    w = words.to(torch.int64) & (_U32 - 1)
    return (w[..., None] >> _shifts(words.device)) & 1


def unpack_bits(words: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_bits` — words → boolean mask."""
    words = torch.movedim(words, axis, -1)
    *lead, nw = words.shape
    out = _bits(words).reshape(*lead, nw * WORD).to(torch.bool)
    return torch.movedim(out, -1, axis)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count (the paper's POPC), int32."""
    return _bits(words).sum(-1).to(torch.int32)


def row_nnz(words: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Total number of set bits along a packed-word axis, int32."""
    return popcount(words).sum(axis, dtype=torch.int32)


def condense(x: torch.Tensor, mask: torch.Tensor, axis: int = -1
             ) -> torch.Tensor:
    """Front-pack the masked elements of ``x`` along ``axis``, zero tail.

    Per 1-D fiber: ``fiber[mask]`` zero-padded to full length — the JAX
    package's ``bitmap._condense``.  Each masked element is scattered to
    its rank among the fiber's masked elements; the unmasked ones all land
    in one spare slot past the end, which is dropped.
    """
    x = torch.movedim(x, axis, -1)
    mask = torch.movedim(mask, axis, -1).to(torch.bool)
    n = x.shape[-1]
    rank = torch.cumsum(mask, -1) - 1
    idx = torch.where(mask, rank, n)
    out = torch.zeros(*x.shape[:-1], n + 1, dtype=x.dtype, device=x.device)
    out.scatter_(-1, idx, torch.where(mask, x, torch.zeros_like(x)))
    return torch.movedim(out[..., :n].contiguous(), -1, axis)


# ---------------------------------------------------------------------------
# single-level bitmap encoding (paper Fig. 2b)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BitmapMatrix:
    """Bitmap-encoded 2-D matrix.

    values : (rows, cols) condensed non-zeros, zero tail: each column's
             pushed to the top for ``order='col'``, each row's to the left
             for ``order='row'``.
    bitmap : packed int32 words of the original positions, (rows//32,
             cols) for ``order='col'``, (rows, cols//32) for ``'row'``.
    counts : per-column (``'col'``) / per-row (``'row'``) non-zeros, int32.
    order  : ``'col'`` (operand A) or ``'row'`` (operand B).
    """
    values: torch.Tensor
    bitmap: torch.Tensor
    counts: torch.Tensor
    order: str

    @property
    def shape(self) -> Tuple[int, int]:
        r, c = self.bitmap.shape
        return (r * WORD, c) if self.order == "col" else (r, c * WORD)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def nnz(self) -> torch.Tensor:
        return self.counts.sum()


def _axis(order: str) -> int:
    if order not in ("col", "row"):
        raise ValueError(f"order must be 'col'|'row', got {order!r}")
    return 0 if order == "col" else 1


def encode(x: torch.Tensor, order: str) -> BitmapMatrix:
    """Encode a dense (M, N) matrix into bitmap + condensed values,
    condensed down each column (``'col'``) or along each row (``'row'``)."""
    if x.ndim != 2:
        raise ValueError(f"encode expects 2-D, got {tuple(x.shape)}")
    axis = _axis(order)
    mask = x != 0
    return BitmapMatrix(values=condense(x, mask, axis=axis),
                        bitmap=pack_bits(mask, axis=axis),
                        counts=mask.sum(axis, dtype=torch.int32),
                        order=order)


def decode(enc: BitmapMatrix) -> torch.Tensor:
    """Reconstruct the dense matrix: each set bit reads the condensed
    value at its popcount offset."""
    axis = _axis(enc.order)
    mask = unpack_bits(enc.bitmap, axis=axis)
    pos = torch.clamp(torch.cumsum(mask, axis) - 1, min=0)
    gathered = torch.gather(enc.values, axis, pos)
    return torch.where(mask, gathered, torch.zeros_like(gathered))


# ---------------------------------------------------------------------------
# two-level bitmap encoding (paper §III-C, Fig. 9)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TwoLevelBitmap:
    """Tiled two-level encoding of a dense (M, K) matrix.

    values       : tile-major values (Mt, Kt, tm, tk), positionally
                   addressed (the kernels condense inside a tile).
    elem_bitmap  : packed element bitmap per tile (Mt, Kt, tm, tk//32).
    tile_bitmap  : one bit per tile, (Mt, Kt) bool (the "warp-bitmap").
    slice_counts : (Mt, Kt, tk // slice) int32 — non-zero k columns in
                   each ``slice``-wide group of a tile.
    """
    values: torch.Tensor
    elem_bitmap: torch.Tensor
    tile_bitmap: torch.Tensor
    slice_counts: torch.Tensor
    tile_m: int
    tile_k: int
    slice: int

    @property
    def grid(self) -> Tuple[int, int]:
        return tuple(self.tile_bitmap.shape)

    @property
    def shape(self) -> Tuple[int, int]:
        mt, kt = self.tile_bitmap.shape
        return (mt * self.tile_m, kt * self.tile_k)


def encode_two_level(x: torch.Tensor, tile_m: int, tile_k: int,
                     slice: int = 128) -> TwoLevelBitmap:
    """Tile a dense (M, K) matrix and build both bitmap levels."""
    m, k = x.shape
    if m % tile_m or k % tile_k or tile_k % WORD or tile_k % slice:
        raise ValueError(f"shape {tuple(x.shape)} not tileable by "
                         f"({tile_m},{tile_k},{slice})")
    mt, kt = m // tile_m, k // tile_k
    tiles = x.reshape(mt, tile_m, kt, tile_k).permute(0, 2, 1, 3)
    mask = tiles != 0
    col_active = mask.any(-2)                              # (Mt, Kt, tk)
    return TwoLevelBitmap(
        values=tiles.contiguous(),
        elem_bitmap=pack_bits(mask, axis=-1),
        tile_bitmap=mask.any(-1).any(-1),
        slice_counts=col_active.reshape(mt, kt, tile_k // slice, slice).sum(
            -1, dtype=torch.int32),
        tile_m=tile_m, tile_k=tile_k, slice=slice)


def decode_two_level(enc: TwoLevelBitmap) -> torch.Tensor:
    mt, kt = enc.grid
    mask = unpack_bits(enc.elem_bitmap, axis=-1)
    tiles = torch.where(mask, enc.values, torch.zeros_like(enc.values))
    return tiles.permute(0, 2, 1, 3).reshape(mt * enc.tile_m,
                                              kt * enc.tile_k)


# ---------------------------------------------------------------------------
# bitmap outer product ("multiply-bitmap", paper §III-A)
# ---------------------------------------------------------------------------

def bitmap_outer(col_bits_a: torch.Tensor,
                 row_bits_b: torch.Tensor) -> torch.Tensor:
    """1-bit outer product of an A-column bitmap (M//32,) and a B-row
    bitmap (N//32,): the packed (M, N//32) bitmap of a ⊗ b — the BOHMMA
    instruction of paper Fig. 14, as word-level selects."""
    a = unpack_bits(col_bits_a, axis=0)
    return torch.where(a[:, None], row_bits_b[None, :],
                       torch.zeros_like(row_bits_b)[None, :])


def tile_activity_outer(a_tiles: torch.Tensor,
                        b_tiles: torch.Tensor) -> torch.Tensor:
    """Level-2 activity: a_tiles (Mt, Kt) and b_tiles (Kt, Nt) bool →
    (Mt, Nt, Kt) bool, True where A tile (i, kb) and B tile (kb, j) are
    both non-empty (the paper's warp-bitmap skip)."""
    return a_tiles[:, None, :] & b_tiles.T[None, :, :]
