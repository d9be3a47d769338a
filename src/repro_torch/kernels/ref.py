"""Oracles for the kernels of this package."""
from __future__ import annotations

import torch


def spgemm_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """Oracle for K1/K2: a plain matmul with float32 accumulation."""
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return (a.to(torch.float32) @ b.to(torch.float32)).to(out_dtype)
