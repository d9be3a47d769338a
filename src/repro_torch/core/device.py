"""Device resolution for the package's entry points.

Entry points (``init_model``, ``generate``, the kernel wrappers) take
``device=None``, which means the card.  Without one they raise instead of
running on the CPU: a run that asked for the GPU path must not quietly
measure the plain path.  Callers that want the CPU pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve(device: Device = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises."""
    dev = (device if isinstance(device, torch.device)
           else torch.device("cuda" if device is None else device))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested (device=None means "
            "'cuda') but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def check_on(t: torch.Tensor, dev: torch.device, what: str) -> None:
    """Raise unless tensor ``t`` lies on device type ``dev``."""
    check_all_on(dev, **{what: t})


def check_all_on(dev: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every named tensor lies on device type ``dev``; on the
    card by ``Tensor.is_cuda``, which builds no device object (the kernel
    wrappers' per-call host time)."""
    cuda = dev.type == "cuda"
    for what, t in tensors.items():
        if not (t.is_cuda if cuda else t.device.type == dev.type):
            raise ValueError(f"{what} lies on {t.device}, expected {dev}")
