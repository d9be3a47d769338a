"""K6 and K7: the implicit bitmap im2col kernels, their wrappers and their
plain versions.

* K6, :func:`sparse_im2col` — replaces the JAX package's TPU kernel
  ``kernels/sparse_im2col.py::sparse_im2col_pallas`` (``_im2col_kernel``):
  stride 1, window bits by word shift/OR, on one of two routes that
  :func:`k6_route` picks: ``feature`` (one block per (image, channel,
  dy) stages each feature row once, in pieces of output words, and
  copies each of its kw windows' values as one contiguous run in 16-byte
  stores) or ``lowered`` (one block per lowered row, for kw in the
  thousands).
* K7, :func:`sparse_im2col_strided` — replaces
  ``kernels/sparse_im2col.py::sparse_im2col_strided_pallas``
  (``_im2col_kernel_strided``): stride ≥ 2, on one of two routes that
  :func:`strided_route` picks: ``feature`` (one block per (image,
  channel, dy) stages each feature row once, in pieces of output words,
  and makes all kw lowered rows from it: whole output words, one warp
  scan of their popcounts) or ``lowered`` (one block per lowered row,
  for the shapes whose pieces would not fit: kw or stride in the
  thousands).

Both take what K5 (:mod:`repro_torch.kernels.bitmap_encode`) leaves —
condensed values cond (N, C, H, W) and bitmaps bits (N, C, H, ceil(W/32))
— and return, for a (kh, kw) kernel, the lowered map in the JAX kernels'
contract with a leading image axis: row-packed bits (N, KKC, OH,
ceil(OW/32)) int32 (each output row starts a fresh word) and the lowered
rows' condensed values (N, KKC, P), P = OH·OW, zero tail.  Lowered row
``k = (dy·kw + dx)·C + c``.  ``ops.rowpacked_to_flat`` turns the bits into
the flat-P layout the planner reads.

On the H100 both are bound by bytes (the lowered values written, the
condensed rows read).  On their feature routes K6
(``csrc/sparse_im2col.cu``) and K7 (``csrc/sparse_im2col_strided.cu``)
read each feature row once for its kw lowered rows.  Outputs are
bit-equal to the plain versions: the kernels move raw bits.

``device=None`` means the card.  CPU tensors run the plain versions; CUDA
tensors launch the kernel or raise.  ``launches`` on each wrapper counts
launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import device as devmod
from repro_torch.core import im2col as i2c
from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
_I32_MAX = 2 ** 31 - 1
# K7's lowered route keeps one int per bitmap word of a feature row in
# static shared memory beside its scan's 33
_SMEM_INTS = 48 * 1024 // 4 - 33
# K6's and K7's feature routes: feature columns one piece stages (at
# most), and output words over all dx one piece holds (K7), or dx one
# block makes (K6: its (off, len, run) per dx in shared memory)
PIECE_COLS, PIECE_WORDS = 4096, 1024
ROUTES = ("lowered", "feature")   # the C entries' route numbers


def _geometry(cond, bits, kh: int, kw: int, stride: int):
    """Check the operands; (n, c, h, w, oh, ow)."""
    if cond.ndim != 4:
        raise ValueError(f"cond must be (N, C, H, W), got "
                         f"{tuple(cond.shape)}")
    n, c, h, w = cond.shape
    ww = -(-w // bm.WORD)
    if tuple(bits.shape) != (n, c, h, ww):
        raise ValueError(f"bits {tuple(bits.shape)} != ({n}, {c}, {h}, "
                         f"{ww})")
    if bits.dtype != torch.int32:
        raise TypeError(f"bits must be int32 bit patterns, not {bits.dtype}")
    if not (1 <= kh <= h and 1 <= kw <= w and stride >= 1):
        raise ValueError(f"kernel ({kh}, {kw}) at stride {stride} does not "
                         f"fit a ({h}, {w}) feature map")
    return (n, c, h, w, i2c.out_size(h, kh, stride),
            i2c.out_size(w, kw, stride))


def _plain(cond, bits, kh, kw, stride):
    n, c, h, w, oh, ow = _geometry(cond, bits, kh, kw, stride)
    mask = bm.unpack_bits(bits, axis=-1)[..., :w]
    low, vals = i2c.lower_rows(mask, cond, kh, kw, stride)
    return bm.pack_bits_padded(low, axis=-1), vals


def sparse_im2col_plain(cond, bits, *, kh: int, kw: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version: unpack, lower (:func:`~repro_torch.core.im2col.
    lower_rows`), repack each output row."""
    return _plain(cond, bits, kh, kw, 1)


def sparse_im2col_strided_plain(cond, bits, *, kh: int, kw: int,
                                stride: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's plain version: the same lowering at ``stride``."""
    return _plain(cond, bits, kh, kw, stride)


def strided_route(n: int, c: int, h: int, w: int, kh: int, kw: int,
                  stride: int) -> Tuple[str, int]:
    """K7's route and piece for (N, C, H, W) feature maps: ``("feature",
    pj)`` with pj output words a piece, as many as a row has and as fit
    :data:`PIECE_COLS` feature columns (32·pj·stride − stride + kw) and
    :data:`PIECE_WORDS` output words over the kw lowered rows; else, or
    when the N·C·kh blocks or a lowered row's P positions pass 2³¹ − 1,
    ``("lowered", 0)``."""
    oh, ow = i2c.out_size(h, kh, stride), i2c.out_size(w, kw, stride)
    pj = min(-(-ow // bm.WORD),
             (PIECE_COLS + stride - kw) // (bm.WORD * stride),
             PIECE_WORDS // kw)
    if pj < 1 or oh * ow > _I32_MAX or n * c * kh > _I32_MAX:
        return "lowered", 0
    return "feature", pj


def k6_route(n: int, c: int, h: int, w: int, kh: int, kw: int
             ) -> Tuple[str, int]:
    """K6's route and piece for (N, C, H, W) feature maps: ``("feature",
    pj)`` with pj output words a piece, as many as a row has and as fit
    :data:`PIECE_COLS` feature columns (32·pj + kw − 1), when kw is at most
    :data:`PIECE_WORDS`; else, or when the N·C·kh blocks or a lowered
    row's P positions pass 2³¹ − 1, ``("lowered", 0)``."""
    oh, ow = i2c.out_size(h, kh, 1), i2c.out_size(w, kw, 1)
    pj = min(-(-ow // bm.WORD), (PIECE_COLS + 1 - kw) // bm.WORD)
    if (pj < 1 or kw > PIECE_WORDS or oh * ow > _I32_MAX
            or n * c * kh > _I32_MAX):
        return "lowered", 0
    return "feature", pj


def _launch(src: str, cond, bits, kh, kw, stride):
    n, c, h, w, oh, ow = _geometry(cond, bits, kh, kw, stride)
    if cond.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {cond.dtype}")
    for t, what in ((cond, "cond"), (bits, "bits")):
        if not t.is_contiguous():
            raise ValueError(f"kernel takes a contiguous {what}")
    kkc = kh * kw * c
    if kkc > _I32_MAX or n > 65535 or max(cond.shape) > _I32_MAX:
        raise ValueError(f"grid ({kkc}, {n}) too large for the kernel")
    if src == "sparse_im2col.cu":
        route, pj = k6_route(n, c, h, w, kh, kw)
    else:
        route, pj = strided_route(n, c, h, w, kh, kw, stride)
        if route == "lowered" and -(-w // bm.WORD) > _SMEM_INTS:
            raise ValueError(f"feature rows of {w} columns exceed the "
                             "shared memory of K7's lowered route")
    out_bits = torch.empty((n, kkc, oh, -(-ow // bm.WORD)),
                           dtype=torch.int32, device=cond.device)
    out_vals = torch.empty((n, kkc, oh * ow), dtype=cond.dtype,
                           device=cond.device)
    stream = torch.cuda.current_stream(cond.device).cuda_stream
    rc = build.function(src)(
        ROUTES.index(route), pj, cond.element_size(), cond.data_ptr(),
        bits.data_ptr(), out_bits.data_ptr(), out_vals.data_ptr(), n, c, h,
        w, kh, kw, stride, stream)
    if rc != 0:
        raise RuntimeError(f"{src}: kernel launch failed with CUDA error "
                           f"{rc}")
    return out_bits, out_vals


def _run(src, plain, cond, bits, kh, kw, stride, device):
    dev = devmod.resolve(device)
    devmod.check_on(cond, dev, "cond")
    devmod.check_on(bits, dev, "bits")
    if dev.type == "cpu":
        return plain()
    return _launch(src, cond, bits, kh, kw, stride)


def sparse_im2col(cond: torch.Tensor, bits: torch.Tensor, *, kh: int,
                  kw: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: stride-1 lowering → (row-packed bits (N, KKC, OH,
    ceil(OW/32)) int32, condensed values (N, KKC, P))."""
    out = _run("sparse_im2col.cu",
               lambda: sparse_im2col_plain(cond, bits, kh=kh, kw=kw),
               cond, bits, kh, kw, 1, device)
    if out[1].is_cuda:
        sparse_im2col.launches += 1
    return out


def sparse_im2col_strided(cond: torch.Tensor, bits: torch.Tensor, *,
                          kh: int, kw: int, stride: int, device=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: the lowering at ``stride`` (≥ 2 on the conv path), same
    outputs as :func:`sparse_im2col`."""
    out = _run("sparse_im2col_strided.cu",
               lambda: sparse_im2col_strided_plain(cond, bits, kh=kh, kw=kw,
                                                   stride=stride),
               cond, bits, kh, kw, stride, device)
    if out[1].is_cuda:
        sparse_im2col_strided.launches += 1
    return out


sparse_im2col.launches = 0
sparse_im2col_strided.launches = 0
