"""K5: dense → bitmap encode, its wrapper and its plain version.

:func:`bitmap_encode` replaces the JAX package's TPU kernel
``kernels/bitmap_encode.py::bitmap_encode_pallas`` (``_encode_kernel``):
per (image, channel, row) of x (N, C, H, W), the LSB-first packed
non-zero bitmap (N, C, H, ceil(W/32)) as int32 bit patterns and the row's
non-zeros front-packed into (N, C, H, W) with a zero tail.  The JAX
kernel takes one image, (C, H, W); its ``vmap`` over images is the
leading N axis here.

On the H100 it is bound by bytes (one read and at most one write of each
element); the CUDA kernel (``csrc/bitmap_encode.cu``) gives each row a
warp that builds each word with ``__ballot_sync`` and each value's slot
with a prefix popcount, reading x through its strides so that an NHWC
feature map needs no transposed copy.  Outputs are bit-equal to the plain
version: the kernel moves raw element bits.

``device=None`` means the card.  CPU tensors run the plain version; CUDA
tensors launch the kernel or raise.  ``bitmap_encode.launches`` counts
launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import device as devmod
from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
_I32_MAX = 2 ** 31 - 1


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
    if max(x.shape) > _I32_MAX or n * c * h > _I32_MAX * 8:
        raise ValueError(f"shape {tuple(x.shape)} too large for the kernel")
    bits = torch.empty((n, c, h, -(-w // bm.WORD)), dtype=torch.int32,
                       device=x.device)
    cond = torch.empty((n, c, h, w), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return bits, cond
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.function("bitmap_encode.cu")(
        x.element_size(), x.data_ptr(), bits.data_ptr(), cond.data_ptr(),
        n, c, h, w, *x.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"bitmap_encode.cu: kernel launch failed with "
                           f"CUDA error {rc}")
    bitmap_encode.launches += 1
    return bits, cond


bitmap_encode.launches = 0
