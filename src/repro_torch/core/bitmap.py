"""Packed bitmaps (paper §III-A): 32 positions per word, LSB-first.

Bit i of word w is position w*32+i — the JAX package's layout.  PyTorch
on the CPU has no shifts for ``uint32``, so words are carried as int32
*bit patterns*: ``words.numpy().view(np.uint32)`` equals the JAX
package's uint32 words.  Shifts run on int64 copies.
"""
from __future__ import annotations

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
