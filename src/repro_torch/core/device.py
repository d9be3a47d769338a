"""Device resolution for the package's entry points.

Entry points (``init_model``, ``generate``, the kernel wrappers) take
``device=None``, which means the card.  Without one they raise instead of
running on the CPU: a run that asked for the GPU path must not quietly
measure the plain path.  Callers that want the CPU pass ``device="cpu"``.

The kernel wrappers write their results into fresh tensors, which carry
no autograd history, so a backward through them would give their inputs
no gradient: :func:`refuse_grad` makes them raise instead, as the JAX
package's ``jax.grad`` raises through ``pallas_call``.
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


class NoBackward(NotImplementedError):
    """A gradient was asked of a kernel: a fault of the caller, never of
    the kernel, so no guard degrades its site for it."""


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise :class:`NoBackward` (a ``NotImplementedError``) when grad mode
    is on and any of ``tensors`` requires grad: no kernel has a backward
    (on either device)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NoBackward(
            f"{kernel}: no backward; a gradient through a kernel is not "
            "supported (train in dense mode or with sparse_use_kernel="
            "False)")
