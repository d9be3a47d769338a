"""The single dispatch point for sparse matmuls.

Every projection of the served model — attention q/k/v/o, MLP up/down and
the LM head — routes through :func:`matmul` (via :func:`project` for the
attention head layouts); the sparse-KV decode attention's score and value
products route through :func:`grouped_matmul` as stacked problems.  The
dispatch

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
``condense="k"``, which plans per contraction index; K3/K4 for the
grouped form).  All modes compute ``x @ w``: sparsity changes the
schedule, not the math.

With ``autotune=True`` a call consults the persistent tuning cache
(:mod:`repro_torch.sparse.autotune`) for its bucketed key; a hit
overrides the geometry and backend knobs, a miss warns once per key and
keeps them.  The model's call sites consult through
:func:`repro_torch.sparse.site.resolve` instead, once per call.  Under
:func:`repro_torch.sparse.validate.enabled` every call first checks its
sparse operands' metadata.
"""
from __future__ import annotations

import contextlib
import inspect
import warnings
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import stats
from repro_torch.kernels import bitmap_spgemm as bsk
from repro_torch.kernels import grouped_spgemm as gsk
from repro_torch.sparse import plan as pln
from repro_torch.sparse import tape
from repro_torch.sparse import validate
from repro_torch.sparse.activation import SparseActivation
from repro_torch.sparse.weights import PlannedWeight

Operand = Union[torch.Tensor, SparseActivation]
Weight = Union[torch.Tensor, PlannedWeight]

MODES = ("dense", "weight", "dual")
CONDENSE = (None, "k")

# keys already warned about: a configuration mismatch (a tuning-cache
# miss, a damaged cache) must be audible, but once per process, not once
# per matmul
_WARNED: set = set()
_SUPPRESS_WARNINGS = False


def warn_once(key: str, message: str) -> None:
    """Emit ``message`` as a RuntimeWarning the first time ``key``
    fires."""
    if key not in _WARNED and not _SUPPRESS_WARNINGS:
        _WARNED.add(key)
        warnings.warn(message, RuntimeWarning, stacklevel=3)


@contextlib.contextmanager
def warnings_suppressed():
    """Silence :func:`warn_once` within a region: passes whose purpose is
    to hit the fallbacks (``Engine.autotune_keys`` discovering keys on an
    empty cache, where every miss is expected).  Suppressed keys are not
    marked warned, so a real later miss stays audible."""
    global _SUPPRESS_WARNINGS
    prev = _SUPPRESS_WARNINGS
    _SUPPRESS_WARNINGS = True
    try:
        yield
    finally:
        _SUPPRESS_WARNINGS = prev


def kwargs_from_config(cfg, out_dtype=None) -> dict:
    """Dispatch kwargs from a ``ModelConfig``'s sparse_* fields: the
    config-constant tier, for direct dispatch users (tests, sweeps); the
    model's call sites resolve through
    :func:`repro_torch.sparse.site.resolve`.  With ``cfg.sparse_autotune``
    the kwargs also carry the per-call cache consultation
    (``autotune=True`` and the sparsity hint), the constants staying as
    the fallback."""
    kw = dict(mode=cfg.sparse_mode, block_m=cfg.sparse_block_m,
              block_n=cfg.sparse_block_n, slice_k=cfg.sparse_slice_k,
              use_kernel=cfg.sparse_use_kernel,
              condense="k" if cfg.sparse_kcondense else None)
    if out_dtype is not None:
        kw["out_dtype"] = out_dtype
    if getattr(cfg, "sparse_autotune", False):
        kw["autotune"] = True
        ts = getattr(cfg, "sparse_tune_sparsity", -1.0)
        if ts is not None and ts >= 0:
            kw["tune_sparsity"] = float(ts)
    return kw


def _consult_autotune(op: str, m: int, n: int, k: int, dtype,
                      tune_sparsity, interp: bool, extra: str = ""):
    """Probe the tuning cache for one call site: the served
    :class:`~repro_torch.sparse.autotune.Knobs` or None.  A miss is
    audible once per bucketed key and falls back to the caller's
    constants — the cache changes the schedule only, never the math."""
    from repro_torch.sparse import autotune as atn
    kn = atn.lookup(op, m, n, k, dtype=dtype, sparsity=tune_sparsity,
                    interpret=interp, extra=extra)
    if kn is None:
        key = atn.make_key(op, m, n, k, dtype=dtype,
                           sparsity=tune_sparsity,
                           platform=atn.platform_of(interp), extra=extra)
        warn_once(
            f"autotune:miss:{key}",
            f"sparse.{op}: no tuning-cache entry for {key} — falling "
            "back to the config constants (sweep it with "
            "repro_torch.sparse.autotune.tune_matmul / tune_attn)")
    return kn


def _cpu_rules(device) -> bool:
    """Whether operands on ``device`` take the tuner's CPU rules (the
    plain walks) rather than the card's."""
    return torch.device(device).type == "cpu"


def _tuned(kw: dict, kn) -> dict:
    """``kw`` with a served knob vector's geometry and backend."""
    if kn is None:
        return kw
    return dict(kw, **kn.kwargs())


def _values(x: Operand) -> torch.Tensor:
    return x.values if isinstance(x, SparseActivation) else x


def _weight_array(w: Weight) -> torch.Tensor:
    return w.w if isinstance(w, PlannedWeight) else w


def _lhs_activity(x: Operand, block_m: int, slice_k: int,
                  mode: str) -> torch.Tensor:
    """(..., Mt, S) block-row slice activity of the activation side
    (..., M, K)."""
    xv = _values(x)
    *lead, m, k = xv.shape
    if mode == "weight":  # activation treated as dense
        return torch.ones(*lead, pln._cdiv(m, block_m), pln._cdiv(k, slice_k),
                          dtype=torch.bool, device=xv.device)
    if isinstance(x, SparseActivation):
        rows = x.row_slice_activity(slice_k)
    else:
        rows = pln.slice_activity_lhs(xv, slice_k)
    return pln.block_reduce_lhs(rows, block_m)


def _rhs_activity(w: Weight, w_arr: torch.Tensor, block_n: int,
                  slice_k: int) -> torch.Tensor:
    """(..., S, Nt) block-col slice activity of the weight side."""
    if isinstance(w, PlannedWeight):
        cols = w.col_slice_activity(slice_k)
    else:
        cols = pln.slice_activity_rhs(w_arr, slice_k)
    return pln.block_reduce_rhs(cols, block_n)


def _lhs_element(x: Operand, block_m: int, mode: str) -> torch.Tensor:
    """(..., Mt, K) block-row element k-activity of the activation side
    (from the packed bitmap when the operand carries one)."""
    xv = _values(x)
    *lead, m, k = xv.shape
    if mode == "weight":  # activation treated as dense
        return torch.ones(*lead, pln._cdiv(m, block_m), k, dtype=torch.bool,
                          device=xv.device)
    if isinstance(x, SparseActivation):
        return pln.element_activity_lhs(x.element_mask(), block_m)
    return pln.element_activity_lhs(xv, block_m)


def _rhs_element(w: Weight, w_arr: torch.Tensor,
                 block_n: int) -> torch.Tensor:
    """(..., K, Nt) block-col element k-activity of the weight side."""
    if isinstance(w, PlannedWeight):
        return w.col_element_activity(block_n)
    return pln.element_activity_rhs(w_arr, block_n)


def schedule(x: Operand, w: Weight, *, mode: str, block_m: int,
             block_n: int, slice_k: int, condense: Optional[str],
             pack: bool = True, w_arr: Optional[torch.Tensor] = None):
    """The schedule of ``x @ w`` at already-clamped geometry: (sched,
    counts), with ``sched`` the K1/K3 slice list ``ks`` or the K2/K4
    :class:`~repro_torch.sparse.plan.KPlan` gather maps — or None when
    ``pack`` is off and only the counts are wanted (the stats tape).
    x (..., M, K) values or SparseActivation, w (..., K, N); ``w_arr`` is
    the weight's values as the product reads them (default: ``w``'s)."""
    if w_arr is None:
        w_arr = _weight_array(w)
    if condense == "k":
        col = _lhs_element(x, block_m, mode)
        row = _rhs_element(w, w_arr, block_n)
        if pack:
            kplan = pln.plan_kcondensed(col, row, slice_k)
            return kplan, kplan.counts
        return None, pln.kcondensed_counts(col, row, slice_k)
    col = _lhs_activity(x, block_m, slice_k, mode)
    row = _rhs_activity(w, w_arr, block_n, slice_k)
    if pack:
        return pln.plan_from_activity(col, row)
    return None, pln.counts_from_activity(col, row)


def _plain_product(xv: torch.Tensor, w_arr: torch.Tensor,
                   out_dtype) -> torch.Tensor:
    """``xv @ w_arr`` as one PyTorch matmul; with ``out_dtype`` computed
    in the wider of the two types, then cast."""
    if out_dtype is None:
        return xv @ w_arr
    ct = torch.promote_types(xv.dtype, out_dtype)
    return (xv.to(ct) @ w_arr.to(ct)).to(out_dtype)


def _dispatch(x: Operand, w: Weight, *, mode: str,
              block_m: int, block_n: int, slice_k: int, use_kernel: bool,
              condense: Optional[str], out_dtype, collect_stats: bool,
              name: str) -> Tuple[torch.Tensor, Optional[stats.StepCounts]]:
    """The body :func:`matmul` ((M, K) @ (K, N)) and :func:`grouped_matmul`
    ((E, C, K) @ (E, K, N)) share: clamp, plan, run, record."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if condense not in CONDENSE:
        raise ValueError(
            f"condense must be one of {CONDENSE}, got {condense!r}")
    xv = _values(x)
    grouped = xv.ndim == 3
    run_kernel = use_kernel and mode != "dense"
    w_arr = _weight_array(w)
    # K3/K4 read a bf16 weight against a float32 activation as it is
    # stored (the decode value's V: no float32 copy of the cache); every
    # other route computes in the activation's type
    if not (grouped and run_kernel and xv.dtype == torch.float32
            and w_arr.dtype == torch.bfloat16):
        w_arr = w_arr.to(xv.dtype)
    c, k = xv.shape[-2:]
    n = w_arr.shape[-1]
    block_m, block_n, slice_k = pln.clamp_geometry(
        c, n, k, block_m, block_n, slice_k)
    geom = dict(block_m=block_m, block_n=block_n, slice_k=slice_k)
    s = pln._cdiv(k, slice_k)

    want_stats = collect_stats or tape.active()
    steps = None
    if mode == "dense":
        if use_kernel or condense:
            warnings.warn(
                f"sparse.{name}: use_kernel/condense have no effect in dense "
                "mode — there is no condensed schedule; executing the dense "
                "matmul (executed == dense steps)", RuntimeWarning,
                stacklevel=3)
        if want_stats:
            e = xv.shape[0] if grouped else 1
            dense = torch.tensor(
                e * pln._cdiv(c, block_m) * pln._cdiv(n, block_n) * s)
            steps = stats.StepCounts(dense=dense, sparse=dense,
                                     tiles_skipped=torch.tensor(0))
    elif run_kernel or want_stats:
        # plan only when something consumes it: the kernel's schedule or
        # the stats accounting
        sched, counts = schedule(x, w, mode=mode, condense=condense,
                                 pack=run_kernel, w_arr=w_arr, **geom)
        if want_stats:
            steps = pln.counts_to_steps(counts, s)
    if run_kernel:
        if grouped:
            kern = (gsk.grouped_spgemm_kfused_planned if condense == "k"
                    else gsk.grouped_spgemm_planned)
        else:
            kern = (bsk.bitmap_spgemm_kfused_planned if condense == "k"
                    else bsk.bitmap_spgemm_planned)
        ks = sched.gk if condense == "k" else sched
        y = kern(xv.contiguous(), w_arr.contiguous(), ks, counts,
                 out_dtype=out_dtype, device=xv.device, **geom)
    else:
        y = _plain_product(xv, w_arr, out_dtype)
    if steps is not None:
        # the kernels execute the condensed schedule; a matmul runs dense
        tape.record(name, steps, steps.sparse if run_kernel else None)
    return y, steps


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
    out_dtype: Optional[torch.dtype] = None,
    collect_stats: bool = False,
    name: str = "matmul",
    autotune: bool = False,
    tune_sparsity: Optional[float] = None,
    op: str = "matmul",
) -> Tuple[torch.Tensor, Optional[stats.StepCounts]]:
    """y = x @ w with mode-selectable dual-side sparse scheduling.

    x: (..., K) tensor or SparseActivation; w: (K, N) tensor or
    PlannedWeight.  Returns (y (..., N), StepCounts or None); stats are
    computed when ``collect_stats`` or a tape is active.  The kernels run
    on the operands' device: their plain versions on the CPU, K1/K2 on
    the card.  ``autotune`` consults the tuning cache for this call's
    key in namespace ``op`` (``"conv"`` for a conv's lowered GEMM),
    bucketed under the sparsity hint ``tune_sparsity``.
    """
    if validate.enabled():
        validate.check_operands(x, w)
    w_arr = _weight_array(w)
    if w_arr.ndim != 2:
        raise ValueError(f"matmul expects 2-D weights, got "
                         f"{tuple(w_arr.shape)}")
    xv = _values(x)
    lead = xv.shape[:-1]
    x2 = (x.flatten_leading() if isinstance(x, SparseActivation)
          else xv.reshape(-1, xv.shape[-1]))
    kw = dict(block_m=block_m, block_n=block_n, slice_k=slice_k,
              use_kernel=use_kernel, condense=condense)
    if autotune and mode != "dense":
        kw = _tuned(kw, _consult_autotune(
            op, lead.numel(), w_arr.shape[1], xv.shape[-1], xv.dtype,
            tune_sparsity, _cpu_rules(xv.device)))
    y, steps = _dispatch(x2, w, mode=mode, out_dtype=out_dtype,
                         collect_stats=collect_stats, name=name, **kw)
    return y.reshape(*lead, y.shape[-1]), steps


def grouped_matmul(
    x: Operand,
    w: Weight,
    *,
    mode: str = "dense",
    block_m: int = 128,
    block_n: int = 128,
    slice_k: int = pln.SLICE_K,
    use_kernel: bool = False,
    condense: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    collect_stats: bool = False,
    name: str = "grouped_matmul",
    autotune: bool = False,
    tune_sparsity: Optional[float] = None,
) -> Tuple[torch.Tensor, Optional[stats.StepCounts]]:
    """Stacked-weights matmul: x (E, C, K) @ w (E, K, N) → (E, C, N).

    Each problem has its own weight and its own activation rows, filled
    to a different count (ragged occupancy: MoE capacity buffers, or the
    decode attention's per-(batch, KV head) cache slots).  With
    ``use_kernel`` K3 (K4 under ``condense="k"``) runs one grid over every
    problem and executes the per-problem schedules; otherwise one
    ``torch.matmul`` with the same schedule accounting, whose summed
    StepCounts the tape records as one entry.  ``out_dtype`` sets the
    accumulation and output type (f32 for the attention sites).
    ``autotune``/``tune_sparsity`` as in :func:`matmul`, the key carrying
    the problem-count bucket.
    """
    if validate.enabled():
        validate.check_operands(x, w)
    xv = _values(x)
    w_arr = _weight_array(w)
    if xv.ndim != 3 or w_arr.ndim != 3:
        raise ValueError(f"grouped_matmul expects (E,C,K)×(E,K,N), got "
                         f"{tuple(xv.shape)} × {tuple(w_arr.shape)}")
    kw = dict(block_m=block_m, block_n=block_n, slice_k=slice_k,
              use_kernel=use_kernel, condense=condense)
    if autotune and mode != "dense":
        from repro_torch.sparse import autotune as atn
        e, c, k = xv.shape
        kw = _tuned(kw, _consult_autotune(
            "grouped", c, w_arr.shape[-1], k, xv.dtype, tune_sparsity,
            _cpu_rules(xv.device), extra=f"e{atn.bucket_dim(e)}"))
    return _dispatch(x, w, mode=mode, out_dtype=out_dtype,
                     collect_stats=collect_stats, name=name, **kw)


# every knob project may forward to matmul: a typo'd knob must raise
_MATMUL_KNOBS = frozenset(
    p for p in inspect.signature(matmul).parameters if p not in ("x", "w"))


def project(
    x: Operand,
    w: Weight,
    *,
    n_contract: int = 1,
    plan_act: Optional[torch.Tensor] = None,
    plan_slice_k: Optional[int] = None,
    **kwargs,
) -> Tuple[torch.Tensor, Optional[stats.StepCounts]]:
    """Tensor projection through :func:`matmul`.

    Contracts the last ``n_contract`` axes of ``x`` with the first
    ``n_contract`` axes of ``w`` and keeps the remaining weight axes —
    ``bsd,dhk->bshk`` (n_contract=1) and ``bshk,hkd->bsd`` (n_contract=2).
    ``plan_act`` is an optional cached (S, prod(out dims)) weight-side
    slice activity over the flattened contraction axis, built at
    ``plan_slice_k`` (default: the call's ``slice_k``); a call at another
    slice_k (a tuned one) re-reduces the weight instead of reading it.
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
                    kflat, plan_slice_k or kwargs.get("slice_k",
                                                      pln.SLICE_K)))
    y, steps = matmul(x_in, w_in, **kwargs)
    return y.reshape(*y.shape[:-1], *out_dims), steps
