"""Core of the dual-side sparse Tensor Core: bitmap encodings, im2col,
outer-product SpGEMM, SpCONV, sparse linear layers, pruning and the
step-count models (the JAX package's ``core``, the same names).
"""
from repro_torch.core import (bitmap, im2col, layers, pruning, spconv,
                              spgemm, stats)

__all__ = ["bitmap", "im2col", "layers", "pruning", "spconv", "spgemm",
           "stats"]
