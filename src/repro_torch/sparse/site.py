"""Declarative per-call-site dispatch resolution (the JAX package's
``sparse/site.py``).

* :class:`OpSite` names one call site — its op kind (the tuning cache's
  namespace: ``matmul``/``grouped``/``conv``/``attn.score``/
  ``attn.value``), its tape name, the logical axes of its weight, and
  optional shape/dtype/sparsity hints and an output dtype pin.  Layers
  build sites once through the memoized :func:`make` and attach them to
  their cached plans.
* :func:`resolve` turns a site, a ``ModelConfig`` and the call's
  geometry into dispatch knobs through three tiers:

  1. **tuning cache** (``cfg.sparse_autotune``) — the bucketed
     (platform, dtype, op, M/N/K, sparsity[, E]) key of
     :mod:`repro_torch.sparse.autotune`, the served knobs re-validated by
     :func:`repro_torch.sparse.plan.knobs_valid`;
  2. **cost model** (``cfg.sparse_costmodel``) — the top
     :func:`repro_torch.sparse.autotune.candidates` pick (sparse roofline
     and step-fraction scorer) when the cache has no measurement;
  3. **config constants** — the ``sparse_*`` fields, with the decode
     attention's twist: ``attn.score`` tiles its rows (cache slots) and
     ``attn.value`` slices its contraction (cache slots again) at
     ``cfg.sparse_block_t``.

* :func:`matmul` / :func:`grouped_matmul` / :func:`project` /
  :func:`conv2d` derive the geometry from the operands as the dispatch
  does (so their keys are the ones an ``autotune=True`` dispatch call
  records), resolve once, and call :mod:`repro_torch.sparse.dispatch` /
  :mod:`repro_torch.sparse.conv` with the resolved knobs.

The decode attention sites carry an ``e``-bucket extra (E = batch · KV
heads): ``attn.score`` keys on (M = T slots, N = G, K = head_dim), so
the tuned ``block_m`` is the score's slot tile, and ``attn.value`` on
(M = G, N = head_dim, K = T), so the tuned ``slice_k`` is the value's.

**Quarantine.**  A kernel arm that raises at a site on CPU operands
(where the wrappers run their plain walks), or with an injected
:class:`~repro_torch.testing.faults.FaultInjected`, is retried on the
plain arm (``use_kernel=False``: one PyTorch matmul, the same product)
and the site is quarantined for the process, with a warning and an entry
in :func:`quarantine_report` (the engine's ``health()``).  An error the
plain retry hits too was never the kernel's and propagates.  On the card
any other kernel error propagates: a CUDA tensor launches its kernel or
raises, and never falls back to the plain arm.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import device as devmod
from repro_torch.core import im2col as i2c
from repro_torch.sparse import conv as scv
from repro_torch.sparse import dispatch as dsp
from repro_torch.sparse.activation import SparseActivation

OPS = ("matmul", "grouped", "conv", "attn.score", "attn.value")


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One declarative sparse call site (hashable).

    op        : the tuning cache's namespace — one of :data:`OPS`.
    name      : stats-tape entry name (``mlp.up``, ``attn.score``, …).
    axes      : logical names of the weight's axes (``("embed", "mlp")``,
                ``("experts", "mlp", "embed")``, …).
    shape     : optional logical weight shape (documentation; resolution
                keys on the *call* geometry).
    dtype     : optional compute-dtype name ("" → the operands').
    out_dtype : optional output/accumulation dtype name ("" → the
                dispatch default); the decode attention sites pin
                "float32", as dense attention accumulates.
    sparsity  : static activation-sparsity hint for the cache key (< 0 →
                ``cfg.sparse_tune_sparsity`` / the 'any' bucket).
    """
    op: str
    name: str
    axes: Tuple[str, ...] = ()
    shape: Tuple[int, ...] = ()
    dtype: str = ""
    out_dtype: str = ""
    sparsity: float = -1.0


@functools.lru_cache(maxsize=None)
def make(op: str, name: str, *, axes: Tuple[str, ...] = (),
         shape: Tuple[int, ...] = (), dtype: str = "",
         out_dtype: str = "", sparsity: float = -1.0) -> OpSite:
    """Memoized :class:`OpSite` constructor: every call returns the same
    descriptor object."""
    if op not in OPS:
        raise ValueError(f"OpSite op must be one of {OPS}, got {op!r}")
    return OpSite(op=op, name=name, axes=tuple(axes), shape=tuple(shape),
                  dtype=dtype, out_dtype=out_dtype,
                  sparsity=float(sparsity))


# ---------------------------------------------------------------------------
# per-site quarantine: a kernel backend that raised at a site runs its
# plain arm for the rest of the process (the same product)

_QUARANTINED: dict = {}          # (op, name) -> first failure reason


def quarantined(st: OpSite) -> bool:
    return (st.op, st.name) in _QUARANTINED


def quarantine(st: OpSite, reason: str) -> None:
    _QUARANTINED.setdefault((st.op, st.name), reason)


def clear_quarantine() -> None:
    """Lift all quarantines."""
    _QUARANTINED.clear()


def quarantine_report() -> dict:
    """``{"op:name": reason}`` — part of ``Engine.health()``."""
    return {f"{op}:{name}": r
            for (op, name), r in sorted(_QUARANTINED.items())}


def _degrade(st: OpSite, kw: dict) -> dict:
    """Force the plain arm of a quarantined site's resolved knobs."""
    if _QUARANTINED and kw.get("use_kernel") and quarantined(st):
        kw = dict(kw, use_kernel=False, condense=None)
    return kw


def _quarantinable(e: Exception, device) -> bool:
    """Whether a kernel-arm failure may degrade its site: on CPU operands,
    or an injected fault anywhere.  On the card a real kernel error
    propagates, and so does a gradient asked of a kernel
    (``devmod.NoBackward``) on either device, as ``jax.grad`` raises
    through ``pallas_call``."""
    if isinstance(e, devmod.NoBackward):
        return False
    if torch.device(device).type == "cpu":
        return True
    from repro_torch.testing.faults import FaultInjected
    return isinstance(e, FaultInjected)


def _guarded(st: OpSite, kw: dict, call, device):
    """Run ``call(kw)``; a kernel-arm failure that :func:`_quarantinable`
    admits retries on the plain arm and quarantines the site.  If the
    retry also fails, the error was never the kernel's: it propagates."""
    if not kw.get("use_kernel"):
        return call(kw)
    try:
        return call(kw)
    except Exception as e:  # noqa: BLE001 — backend failures are varied
        if not _quarantinable(e, device):
            raise
        fallback = dict(kw, use_kernel=False, condense=None)
        out = call(fallback)          # raises if the fault wasn't the kernel's
        quarantine(st, f"{type(e).__name__}: {e}")
        dsp.warn_once(
            f"quarantine:{st.op}:{st.name}",
            f"sparse.site: kernel backend failed at {st.op}:{st.name} "
            f"({type(e).__name__}: {e}); site degraded to the plain arm "
            "for the rest of the process (numerics preserved)")
        return out


def _base_kwargs(st: OpSite, cfg) -> dict:
    """Tier 3: the config constants for this site."""
    kw = dict(mode=cfg.sparse_mode, block_m=cfg.sparse_block_m,
              block_n=cfg.sparse_block_n, slice_k=cfg.sparse_slice_k,
              use_kernel=cfg.sparse_use_kernel,
              condense="k" if cfg.sparse_kcondense else None)
    if st.op == "attn.score":      # cache slots are the rows
        kw["block_m"] = cfg.sparse_block_t
    elif st.op == "attn.value":    # cache slots are the contraction
        kw["slice_k"] = cfg.sparse_block_t
    if st.out_dtype:
        kw["out_dtype"] = getattr(torch, st.out_dtype)
    return kw


@functools.lru_cache(maxsize=None)
def _costmodel_knobs(op: str, m: int, n: int, k: int, e: int,
                     dtype_name: str, sparsity: float, interp: bool):
    """Tier 2: the best analytic candidate (memoized: resolution runs on
    every call)."""
    from repro_torch.sparse import autotune as atn
    cands = atn.candidates(
        m, n, k, a_sparsity=max(sparsity, 0.0),
        dtype_bytes=atn._DTYPE_BYTES.get(dtype_name, 4),
        interpret=interp, n_groups=max(e, 1), max_candidates=1)
    return cands[0] if cands else None


def resolve(st: OpSite, cfg, *, m: int, n: int, k: int, e: int = 1,
            dtype=torch.float32, device=None) -> dict:
    """Site + config + call geometry → dispatch knobs.

    The cache → cost model → config chain (module docstring).  Dense mode
    (there is no schedule to tune), or neither tuning tier on, returns
    the config constants at once.
    ``device`` (the operands') picks the tuner's rules: the CPU's for the
    plain walks, the card's otherwise; without one, the card's where one
    is present.  The result never carries ``autotune``: consultation
    happens here, once.
    """
    kw = _base_kwargs(st, cfg)
    if cfg.sparse_mode == "dense" or not (cfg.sparse_autotune
                                          or cfg.sparse_costmodel):
        return _degrade(st, kw)
    interp = (dsp._cpu_rules(device) if device is not None
              else not torch.cuda.is_available())
    from repro_torch.sparse import autotune as atn
    dt = atn.dtype_name(st.dtype or dtype)
    hint = st.sparsity if st.sparsity >= 0 else float(
        getattr(cfg, "sparse_tune_sparsity", -1.0))
    hint = hint if hint >= 0 else None
    extra = ""
    if st.op in ("grouped", "attn.score", "attn.value"):
        extra = f"e{atn.bucket_dim(e)}"
    if cfg.sparse_autotune:
        kn = dsp._consult_autotune(st.op, m, n, k, dt, hint, interp,
                                   extra=extra)
        if kn is not None:
            kw.update(kn.kwargs())
            return _degrade(st, kw)
    if cfg.sparse_costmodel:
        kn = _costmodel_knobs(st.op, int(m), int(n), int(k), int(e), dt,
                              -1.0 if hint is None else hint, interp)
        if kn is not None:
            kw.update(kn.kwargs())
    return _degrade(st, kw)


def _site_of(w, site: Optional[OpSite]) -> OpSite:
    st = site if site is not None else getattr(w, "site", None)
    if st is None:
        raise ValueError("sparse.site: no OpSite — pass one explicitly or "
                         "attach it to the PlannedWeight/PlannedConv")
    return st


def matmul(x, w, site: Optional[OpSite], cfg, *,
           collect_stats: bool = False):
    """Site-resolved :func:`repro_torch.sparse.dispatch.matmul`."""
    st = _site_of(w, site)
    xv = dsp._values(x)
    kw = resolve(st, cfg, m=xv.shape[:-1].numel(),
                 n=dsp._weight_array(w).shape[-1], k=xv.shape[-1],
                 dtype=xv.dtype, device=xv.device)
    return _guarded(st, kw, lambda kw2: dsp.matmul(
        x, w, name=st.name, op=st.op, collect_stats=collect_stats, **kw2),
        xv.device)


def grouped_matmul(x, w, site: Optional[OpSite], cfg, *,
                   collect_stats: bool = False,
                   resolved: Optional[dict] = None):
    """Site-resolved :func:`repro_torch.sparse.dispatch.grouped_matmul`
    (the KV decode path resolves first, to build its operands at the
    served tile, and injects the knobs as ``resolved``)."""
    st = _site_of(w, site)
    xv = dsp._values(x)
    e, c, k = xv.shape
    kw = resolved if resolved is not None else resolve(
        st, cfg, m=c, n=dsp._weight_array(w).shape[-1], k=k, e=e,
        dtype=xv.dtype, device=xv.device)
    return _guarded(st, kw, lambda kw2: dsp.grouped_matmul(
        x, w, name=st.name, collect_stats=collect_stats, **kw2), xv.device)


def project(x, w, site: Optional[OpSite], cfg, *, n_contract: int = 1,
            plan_act=None, collect_stats: bool = False):
    """Site-resolved :func:`repro_torch.sparse.dispatch.project` (the
    attention and head tensor projections).  ``plan_act`` is the cached
    weight activity ``plan_weight_activities`` builds at
    ``cfg.sparse_slice_k``; a tuned slice_k re-reduces the weight."""
    st = _site_of(w, site)
    w_arr = dsp._weight_array(w)
    kflat = w_arr.shape[:n_contract].numel()
    n = w_arr.shape[n_contract:].numel()
    xv = dsp._values(x)
    lead = (xv.shape[:-1] if isinstance(x, SparseActivation)
            else xv.shape[:xv.ndim - n_contract])
    kw = resolve(st, cfg, m=lead.numel(), n=n, k=kflat, dtype=xv.dtype,
                 device=xv.device)
    return _guarded(st, kw, lambda kw2: dsp.project(
        x, w, n_contract=n_contract, plan_act=plan_act,
        plan_slice_k=cfg.sparse_slice_k, name=st.name, op=st.op,
        collect_stats=collect_stats, **kw2), xv.device)


def conv2d(x, w, stride: int = 1, *, site: Optional[OpSite] = None,
           cfg=None, collect_stats: bool = False):
    """Site-resolved :func:`repro_torch.sparse.conv.conv2d` (w a
    (KH, KW, C, F) tensor or a :class:`~repro_torch.sparse.conv.
    PlannedConv`).  Keys on the lowered GEMM — M = N·OH·OW output
    positions, K = KH·KW·C, N = F filters — the (m, n, k) the inner
    ``dispatch.matmul(op="conv")`` would key on."""
    st = _site_of(w, site)
    kh, kw_sp, c, f = w.shape
    xs = x.shape if x.ndim == 4 else (1,) + tuple(x.shape)
    nb, h, wid = xs[0], xs[1], xs[2]
    m = nb * i2c.out_size(h, kh, stride) * i2c.out_size(wid, kw_sp, stride)
    kw = resolve(st, cfg, m=m, n=f, k=kh * kw_sp * c, dtype=x.dtype,
                 device=x.device)
    return _guarded(st, kw, lambda kw2: scv.conv2d(
        x, w, stride, name=st.name, collect_stats=collect_stats, **kw2),
        x.device)
