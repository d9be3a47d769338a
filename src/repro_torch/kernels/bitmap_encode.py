"""K5: dense → bitmap encode, its wrapper and its plain version.

:func:`bitmap_encode` replaces the JAX package's TPU kernel
``kernels/bitmap_encode.py::bitmap_encode_pallas`` (``_encode_kernel``):
per (image, channel, row) of x (N, C, H, W), the LSB-first packed
non-zero bitmap (N, C, H, ceil(W/32)) as int32 bit patterns and the row's
non-zeros front-packed into (N, C, H, W) with a zero tail.  The JAX
kernel takes one image, (C, H, W); its ``vmap`` over images is the
leading N axis here.

On the H100 it is bound by bytes (one read and at most one write of each
element).  The CUDA kernel (``csrc/bitmap_encode.cu``) reads x through its
strides, so an NHWC feature map needs no transposed copy, on one of two
routes that :func:`encode_route` picks:

* ``channels`` — the conv path's NHWC view (channels contiguous, 16-byte
  loads possible, C ≥ 32): blocks take tiles of 32 channels × 128 columns
  of one (image, row), each lane loading one column's channels along C
  with 16-byte loads and a warp ballot making each channel's words; two
  device passes (words and segment counts, then values and the zero
  tail), one call;
* ``rows`` — every other layout: one warp walks one row.

Outputs are bit-equal to the plain version: the kernel moves raw element
bits.

``device=None`` means the card.  CPU tensors run the plain version; CUDA
tensors launch the kernel or raise.  ``bitmap_encode.launches`` counts
calls that launched the kernel (one a call, whatever its passes).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import device as devmod
from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
_I32_MAX = 2 ** 31 - 1
ROUTES = ("rows", "channels")     # the C entry's route numbers, in order
TILE_C, SEG = 32, 128             # a channels-route tile: channels, columns
_VEC_BYTES = 16                   # one load


def encode_route(x: torch.Tensor) -> str:
    """K5's route for x (N, C, H, W): ``channels`` when its channels are
    contiguous and 16-byte loads can take them (C ≥ 32, C × element size,
    the base address and the strides of every axis longer than 1
    multiples of 16 bytes), else ``rows``."""
    e = x.element_size()
    n, c, h, w = x.shape
    if c < TILE_C or x.stride(1) != 1 or (c * e) % _VEC_BYTES:
        return "rows"
    if x.data_ptr() % _VEC_BYTES:
        return "rows"
    for size, stride in zip((n, h, w), (x.stride(0), x.stride(2),
                                        x.stride(3))):
        if size > 1 and (stride * e) % _VEC_BYTES:
            return "rows"
    return "channels"


def encode_blocks(x: torch.Tensor, route: str) -> int:
    """CUDA blocks of each device pass on ``route``."""
    n, c, h, w = x.shape
    if route == "rows":
        return -(-n * c * h // 8)
    return -(-w // SEG) * -(-c // TILE_C) * h * n


def bitmap_encode_plain(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: x (..., W) → (bits (..., ceil(W/32)) int32,
    condensed values (..., W))."""
    mask = x != 0
    return (bm.pack_bits_padded(mask, axis=-1),
            bm.condense(x, mask, axis=-1))


def bitmap_encode(x: torch.Tensor, *, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: x (N, C, H, W), any strides → (bits (N, C, H, ceil(W/32))
    int32, cond (N, C, H, W) contiguous, x's dtype)."""
    dev = devmod.resolve(device)
    devmod.check_on(x, dev, "x")
    if x.ndim != 4:
        raise ValueError(f"bitmap_encode takes (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    if dev.type == "cpu":
        return bitmap_encode_plain(x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {x.dtype}")
    n, c, h, w = x.shape
    route = encode_route(x)
    if (max(x.shape) > _I32_MAX or n * c * h > _I32_MAX * 8
            or encode_blocks(x, route) > _I32_MAX):
        raise ValueError(f"shape {tuple(x.shape)} too large for the kernel")
    bits = torch.empty((n, c, h, -(-w // bm.WORD)), dtype=torch.int32,
                       device=x.device)
    cond = torch.empty((n, c, h, w), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return bits, cond
    counts = (torch.empty((n * c * h, -(-w // SEG)), dtype=torch.int32,
                          device=x.device) if route == "channels" else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.function("bitmap_encode.cu")(
        ROUTES.index(route), x.element_size(), x.data_ptr(), bits.data_ptr(),
        cond.data_ptr(), 0 if counts is None else counts.data_ptr(),
        n, c, h, w, *x.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"bitmap_encode.cu ({route} route): kernel launch "
                           f"failed with CUDA error {rc}")
    bitmap_encode.launches += 1
    return bits, cond


bitmap_encode.launches = 0
