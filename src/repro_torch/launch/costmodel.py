"""The analytic step model (the JAX package's ``launch/costmodel.py``, in
part): the expected executed-step fraction of a dual-side sparse schedule,
which the autotuner's scorer folds into
:func:`repro_torch.launch.roofline.sparse_matmul`.

``step_costs`` and its helpers (per-cell FLOPs, bytes and collectives)
serve the dry run and training and wait for them.
"""
from __future__ import annotations

from typing import Dict


def sparse_step_fraction(block_m: int, block_n: int, slice_k: int, k: int,
                         *, a_density: float = 1.0, w_density: float = 1.0,
                         condense=None) -> float:
    """Expected executed-step fraction of a dual-side sparse schedule,
    under an iid-Bernoulli element model: each A element non-zero with
    probability ``a_density``, each B element with ``w_density``.

    Slice-granular (``condense=None``): a (block, slice) pair is active
    iff any of its block_m·slice_k A elements (block_n·slice_k B
    elements) is non-zero, and a step executes iff both sides are active
    — fraction = p_A · p_B.

    Element-granular (``condense="k"``): contraction index k survives the
    AND iff some A row and some B column of the block are non-zero there;
    executed steps are ceil(nnz_AND / slice_k), so the fraction is nnz/K,
    at least one step's worth when anything survives.
    """
    a = min(max(float(a_density), 0.0), 1.0)
    w = min(max(float(w_density), 0.0), 1.0)
    s = max(-(-k // slice_k), 1)
    if condense == "k":
        p_a = 1.0 - (1.0 - a) ** block_m
        p_b = 1.0 - (1.0 - w) ** block_n
        nnz = k * p_a * p_b
        if nnz <= 0.0:
            return 0.0
        return min(max(nnz / slice_k, 1.0), float(s)) / s
    p_a = 1.0 - (1.0 - a) ** (block_m * slice_k)
    p_b = 1.0 - (1.0 - w) ** (block_n * slice_k)
    return p_a * p_b


def predict_sparse_steps(m: int, n: int, k: int, block_m: int, block_n: int,
                         slice_k: int, *, a_density: float = 1.0,
                         w_density: float = 1.0, condense=None
                         ) -> Dict[str, float]:
    """StepCounts-shaped prediction for one (m, n, k) matmul: dense grid
    steps, predicted executed steps and the executed fraction."""
    mt = -(-m // block_m)
    nt = -(-n // block_n)
    s = -(-k // slice_k)
    frac = sparse_step_fraction(block_m, block_n, slice_k, k,
                                a_density=a_density, w_density=w_density,
                                condense=condense)
    dense = float(mt * nt * s)
    return {"dense_steps": dense, "executed_steps": dense * frac,
            "executed_fraction": frac}
