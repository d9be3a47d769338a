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
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested (device=None means "
            "'cuda') but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def check_on(t: torch.Tensor, dev: torch.device, what: str) -> None:
    """Raise unless tensor ``t`` lies on device type ``dev``."""
    if t.device.type != dev.type:
        raise ValueError(f"{what} lies on {t.device}, expected {dev}")
