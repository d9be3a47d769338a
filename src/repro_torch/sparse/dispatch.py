"""The single dispatch point for sparse matmuls.

Every projection of the served model — attention q/k/v/o, MLP up/down and
the LM head — routes through :func:`matmul` (via :func:`project` for the
attention head layouts).  The dispatch

* accepts any leading batch shape ``(..., K)`` and flattens it;
* takes a :class:`~repro_torch.sparse.activation.SparseActivation` on the
  activation side and a :class:`~repro_torch.sparse.weights.PlannedWeight`
  on the weight side, or plans from ``x != 0`` / ``w != 0`` when the
  metadata is absent (the two are the same schedule);
* records per-call :class:`~repro_torch.core.stats.StepCounts` to the
  active :mod:`repro_torch.sparse.tape`.

Modes: ``dense`` (plain matmul, dense accounting), ``weight`` (static
weight-side skips only) and ``dual`` (weight AND activation skips; with
``use_kernel`` the K1 kernel executes the condensed schedule, or K2 under
``condense="k"``, which plans per contraction index).  All modes compute
``x @ w``: sparsity changes the schedule, not the math.
"""
from __future__ import annotations

import inspect
import warnings
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import stats
from repro_torch.kernels import bitmap_spgemm as bsk
from repro_torch.sparse import plan as pln
from repro_torch.sparse import tape
from repro_torch.sparse.activation import SparseActivation
from repro_torch.sparse.weights import PlannedWeight

Operand = Union[torch.Tensor, SparseActivation]
Weight = Union[torch.Tensor, PlannedWeight]

MODES = ("dense", "weight", "dual")
CONDENSE = (None, "k")


def _values(x: Operand) -> torch.Tensor:
    return x.values if isinstance(x, SparseActivation) else x


def _weight_array(w: Weight) -> torch.Tensor:
    return w.w if isinstance(w, PlannedWeight) else w


def _lhs_activity(x: Operand, x2: torch.Tensor, block_m: int, slice_k: int,
                  mode: str) -> torch.Tensor:
    """(Mt, S) block-row slice activity of the activation side."""
    if mode == "weight":  # activation treated as dense
        return torch.ones(pln._cdiv(x2.shape[0], block_m),
                          pln._cdiv(x2.shape[1], slice_k), dtype=torch.bool,
                          device=x2.device)
    if isinstance(x, SparseActivation):
        rows = x.flatten_leading().row_slice_activity(slice_k)
    else:
        rows = pln.slice_activity_lhs(x2, slice_k)
    return pln.block_reduce_lhs(rows, block_m)


def _rhs_activity(w: Weight, w_arr: torch.Tensor, block_n: int,
                  slice_k: int) -> torch.Tensor:
    """(S, Nt) block-col slice activity of the weight side."""
    if isinstance(w, PlannedWeight):
        cols = w.col_slice_activity(slice_k)
    else:
        cols = pln.slice_activity_rhs(w_arr, slice_k)
    return pln.block_reduce_rhs(cols, block_n)


def _lhs_element(x: Operand, x2: torch.Tensor, block_m: int,
                 mode: str) -> torch.Tensor:
    """(Mt, K) block-row element k-activity of the activation side (from
    the packed bitmap when the operand carries one)."""
    if mode == "weight":  # activation treated as dense
        return torch.ones(pln._cdiv(x2.shape[0], block_m), x2.shape[1],
                          dtype=torch.bool, device=x2.device)
    if isinstance(x, SparseActivation):
        return pln.element_activity_lhs(
            x.flatten_leading().element_mask(), block_m)
    return pln.element_activity_lhs(x2, block_m)


def _rhs_element(w: Weight, w_arr: torch.Tensor,
                 block_n: int) -> torch.Tensor:
    """(K, Nt) block-col element k-activity of the weight side."""
    if isinstance(w, PlannedWeight):
        return w.col_element_activity(block_n)
    return pln.element_activity_rhs(w_arr, block_n)


def matmul(
    x: Operand,
    w: Weight,
    *,
    mode: str = "dense",
    block_m: int = 128,
    block_n: int = 128,
    slice_k: int = pln.SLICE_K,
    use_kernel: bool = False,
    condense: Optional[str] = None,
    collect_stats: bool = False,
    name: str = "matmul",
) -> Tuple[torch.Tensor, Optional[stats.StepCounts]]:
    """y = x @ w with mode-selectable dual-side sparse scheduling.

    x: (..., K) tensor or SparseActivation; w: (K, N) tensor or
    PlannedWeight.  Returns (y (..., N), StepCounts or None); stats are
    computed when ``collect_stats`` or a tape is active.  The kernels run
    on the operands' device: their plain versions on the CPU, K1/K2 on
    the card.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if condense not in CONDENSE:
        raise ValueError(
            f"condense must be one of {CONDENSE}, got {condense!r}")
    w_arr = _weight_array(w)
    if w_arr.ndim != 2:
        raise ValueError(f"matmul expects 2-D weights, got "
                         f"{tuple(w_arr.shape)}")
    xv = _values(x)
    lead = xv.shape[:-1]
    k = xv.shape[-1]
    x2 = xv.reshape(-1, k)
    t = x2.shape[0]
    n = w_arr.shape[1]
    w_arr = w_arr.to(xv.dtype)

    block_m, block_n, slice_k = pln.clamp_geometry(
        t, n, k, block_m, block_n, slice_k)
    mt, nt, s = (pln._cdiv(t, block_m), pln._cdiv(n, block_n),
                 pln._cdiv(k, slice_k))

    want_stats = collect_stats or tape.active()
    steps = None
    if mode == "dense":
        if use_kernel or condense:
            warnings.warn(
                "sparse.matmul: use_kernel/condense have no effect in dense "
                "mode — there is no condensed schedule; executing the dense "
                "matmul (executed == dense steps)", RuntimeWarning,
                stacklevel=2)
        y = x2 @ w_arr
        if want_stats:
            dense = torch.tensor(mt * nt * s)
            steps = stats.StepCounts(dense=dense, sparse=dense,
                                     tiles_skipped=torch.tensor(0))
    else:
        # plan only when something consumes it: the kernel's schedule or
        # the stats accounting
        if use_kernel or want_stats:
            if condense == "k":
                col_e = _lhs_element(x, x2, block_m, mode)
                row_e = _rhs_element(w, w_arr, block_n)
                if use_kernel:
                    kplan = pln.plan_kcondensed(col_e, row_e, slice_k)
                    counts = kplan.counts
                else:
                    counts = pln.kcondensed_counts(col_e, row_e, slice_k)
            else:
                col = _lhs_activity(x, x2, block_m, slice_k, mode)
                row = _rhs_activity(w, w_arr, block_n, slice_k)
                if use_kernel:
                    ks, counts = pln.plan_from_activity(col, row)
                else:
                    counts = pln.counts_from_activity(col, row)
            if want_stats:
                steps = pln.counts_to_steps(counts, s)
        if use_kernel:
            geom = dict(block_m=block_m, block_n=block_n, slice_k=slice_k,
                        device=x2.device)
            a, b = x2.contiguous(), w_arr.contiguous()
            if condense == "k":
                y = bsk.bitmap_spgemm_kfused_planned(
                    a, b, kplan.gk, kplan.counts, **geom)
            else:
                y = bsk.bitmap_spgemm_planned(a, b, ks, counts, **geom)
        else:
            y = x2 @ w_arr
    if steps is not None:
        # the kernels execute the condensed schedule; a matmul runs dense
        tape.record(name, steps,
                    steps.sparse if mode != "dense" and use_kernel
                    else None)
    return y.reshape(*lead, n), steps


# every knob project may forward to matmul: a typo'd knob must raise
_MATMUL_KNOBS = frozenset(
    p for p in inspect.signature(matmul).parameters if p not in ("x", "w"))


def project(
    x: Operand,
    w: Weight,
    *,
    n_contract: int = 1,
    plan_act: Optional[torch.Tensor] = None,
    **kwargs,
) -> Tuple[torch.Tensor, Optional[stats.StepCounts]]:
    """Tensor projection through :func:`matmul`.

    Contracts the last ``n_contract`` axes of ``x`` with the first
    ``n_contract`` axes of ``w`` and keeps the remaining weight axes —
    ``bsd,dhk->bshk`` (n_contract=1) and ``bshk,hkd->bsd`` (n_contract=2).
    ``plan_act`` is an optional cached (S, prod(out dims)) weight-side
    slice activity over the flattened contraction axis.
    """
    unknown = set(kwargs) - _MATMUL_KNOBS
    if unknown:
        raise TypeError(
            f"sparse.project: unknown dispatch knob(s) {sorted(unknown)}; "
            f"valid knobs: {sorted(_MATMUL_KNOBS)}")
    w_arr = _weight_array(w)
    k_dims = w_arr.shape[:n_contract]
    out_dims = w_arr.shape[n_contract:]
    kflat = 1
    for d in k_dims:
        kflat *= d
    if isinstance(x, SparseActivation):
        if n_contract != 1:
            raise ValueError("SparseActivation carries metadata over one "
                             "contraction axis only")
        x_in: Operand = x
    else:
        x_in = x.reshape(*x.shape[:x.ndim - n_contract], kflat)
    if isinstance(w, PlannedWeight) and n_contract == 1 and not out_dims[1:]:
        w_in: Weight = w
    else:
        w_in = w_arr.reshape(kflat, -1)
        if plan_act is not None:
            w_in = PlannedWeight(
                w=w_in, slice_act=plan_act,
                slice_k=pln.effective_slice_k(
                    kflat, kwargs.get("slice_k", pln.SLICE_K)))
    y, steps = matmul(x_in, w_in, **kwargs)
    return y.reshape(*y.shape[:-1], *out_dims), steps
