"""Roofline terms for the card (the JAX package's ``launch/roofline.py``,
in part).

  compute term    = FLOPs / peak FLOP/s
  memory term     = HBM bytes / HBM bandwidth
  collective term = collective bytes / link bandwidth

Hardware model: one NVIDIA H100 SXM 80GB at its 700 W limit (the figures
``chip_smoke.py`` bounds every kernel by): 989 TFLOP/s dense bf16 on the
tensor cores, 3.35 TB/s of HBM3, and NVLink 4's 450 GB/s per direction in
place of the TPU's ICI link.

Ported: :func:`roofline`, :func:`model_flops` and :func:`sparse_matmul`,
the autotuner's candidate scorer.  The JAX module's ``collective_bytes``,
``cost_summary`` and ``memory_summary`` read a compiled XLA executable and
wait for a port of ``launch/dryrun.py``.
"""
from __future__ import annotations

from typing import Any, Dict

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores, H100 SXM 80GB
HBM_BW = 3.35e12           # bytes/s, HBM3, H100 SXM 80GB
LINK_BW = 450e9            # bytes/s per direction, NVLink 4, H100 SXM


def roofline(flops: float, hbm_bytes: float, coll_bytes: float
             ) -> Dict[str, Any]:
    t_c = flops / PEAK_FLOPS
    t_m = hbm_bytes / HBM_BW
    t_x = coll_bytes / LINK_BW
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dom = max(terms, key=terms.get)
    bound = max(t_c, t_m, t_x)
    terms["bottleneck"] = dom
    terms["roofline_s"] = bound
    terms["compute_fraction_of_roofline"] = t_c / bound if bound else 0.0
    return terms


def model_flops(n_active_params: float, tokens: float, kind: str) -> float:
    """6·N·D (train) / 2·N·D (inference)."""
    per_tok = 6.0 if kind == "train" else 2.0
    return per_tok * n_active_params * tokens


def sparse_matmul(m: int, n: int, k: int, *, executed_fraction: float = 1.0,
                  block_m: int = 128, block_n: int = 128,
                  dtype_bytes: int = 2, backend: str = "kernel",
                  step_overhead_s: float = 0.0) -> Dict[str, Any]:
    """Sparse-aware roofline terms for one (m, n, k) matmul: the
    autotuner's candidate scorer.

    Folds the predicted executed-step fraction
    (:func:`repro_torch.launch.costmodel.sparse_step_fraction`) into the
    FLOP term and, by backend, the HBM term:

    * ``backend="xla"`` — the dense arm (``torch.matmul``): full FLOPs, A
      streamed once per column block, B once per row block, C once;
    * ``backend="kernel"`` — K1/K3: a skipped step reads neither operand,
      so FLOPs *and* operand bytes scale by the executed fraction;
    * ``backend="kfused"`` — K2/K4: FLOPs scale by the (smaller)
      condensed fraction; operand bytes are charged dense, as the JAX
      package charges them.

    ``step_overhead_s`` charges a fixed cost per executed step: zero on
    the card, non-zero for the CPU's plain walks (one PyTorch step a
    schedule position).
    """
    mt = -(-m // block_m)
    nt = -(-n // block_n)
    frac = min(max(float(executed_fraction), 0.0), 1.0)
    flops = 2.0 * m * n * k
    a_bytes = m * k * nt * dtype_bytes       # A panel re-read per col block
    b_bytes = k * n * mt * dtype_bytes       # B panel re-read per row block
    c_bytes = m * n * dtype_bytes
    if backend == "xla":
        frac = 1.0
    elif backend == "kernel":
        a_bytes *= frac
        b_bytes *= frac
    flops *= frac
    hbm = a_bytes + b_bytes + c_bytes
    t_c = flops / PEAK_FLOPS
    t_m = hbm / HBM_BW
    t_o = 0.0 if backend == "xla" else (
        step_overhead_s * mt * nt * max(frac, 1e-9))
    predict = max(t_c, t_m) + t_o
    return {"flops": flops, "hbm_bytes": hbm,
            "arithmetic_intensity": flops / hbm if hbm else 0.0,
            "compute_s": t_c, "memory_s": t_m, "overhead_s": t_o,
            "predict_s": predict,
            "bound": "compute" if t_c >= t_m else "memory"}
