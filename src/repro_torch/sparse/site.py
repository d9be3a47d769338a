"""Declarative per-call-site dispatch resolution.

:class:`OpSite` names one sparse call site — its op kind, its tape name,
the logical axes of its weight and an optional output dtype pin.  Layers
build sites once through the memoized :func:`make`; :func:`resolve` turns
a site and a ``ModelConfig`` into the dispatch knobs.  Only the config
tier is ported: the knobs are the config's ``sparse_*`` constants (no
tuning cache, no cost model), with the decode attention's twist: the
``attn.score`` site tiles its rows (cache slots) and the ``attn.value``
site slices its contraction (cache slots again) at ``sparse_block_t``.
``conv`` sites (the audio stem) resolve like ``matmul`` ones and run
:func:`repro_torch.sparse.conv.conv2d`.

A kernel failure is not caught here: on the card it has to surface.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.sparse import conv as scv
from repro_torch.sparse import dispatch as dsp

OPS = ("matmul", "grouped", "conv", "attn.score", "attn.value")


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One declarative sparse call site (hashable).

    op        : op kind — one of :data:`OPS`.
    name      : stats-tape entry name (``mlp.up``, ``conv.stem1``, …).
    axes      : logical names of the weight's axes (``("embed", "mlp")``, …).
    out_dtype : output/accumulation dtype name ("" → the dispatch default);
                the decode attention sites pin "float32", as dense
                attention accumulates.
    """
    op: str
    name: str
    axes: Tuple[str, ...] = ()
    out_dtype: str = ""


@functools.lru_cache(maxsize=None)
def make(op: str, name: str, *, axes: Tuple[str, ...] = (),
         out_dtype: str = "") -> OpSite:
    """Memoized :class:`OpSite` constructor."""
    if op not in OPS:
        raise ValueError(f"OpSite op must be one of {OPS}, got {op!r}")
    return OpSite(op=op, name=name, axes=tuple(axes), out_dtype=out_dtype)


def resolve(st: OpSite, cfg) -> dict:
    """Site + config → dispatch knobs (the config constants)."""
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


def _site_of(w, site: Optional[OpSite]) -> OpSite:
    st = site if site is not None else getattr(w, "site", None)
    if st is None:
        raise ValueError("sparse.site: no OpSite — pass one explicitly or "
                         "attach it to the PlannedWeight")
    return st


def matmul(x, w, site: Optional[OpSite], cfg, *,
           collect_stats: bool = False):
    """Site-resolved :func:`repro_torch.sparse.dispatch.matmul`."""
    st = _site_of(w, site)
    return dsp.matmul(x, w, name=st.name, collect_stats=collect_stats,
                      **resolve(st, cfg))


def grouped_matmul(x, w, site: Optional[OpSite], cfg, *,
                   collect_stats: bool = False,
                   resolved: Optional[dict] = None):
    """Site-resolved :func:`repro_torch.sparse.dispatch.grouped_matmul`
    (the KV decode path resolves first, to build its operands at the
    served tile, and injects the knobs as ``resolved``)."""
    st = _site_of(w, site)
    kw = resolved if resolved is not None else resolve(st, cfg)
    return dsp.grouped_matmul(x, w, name=st.name,
                              collect_stats=collect_stats, **kw)


def conv2d(x, w, stride: int = 1, *, site: Optional[OpSite] = None,
           cfg=None, collect_stats: bool = False):
    """Site-resolved :func:`repro_torch.sparse.conv.conv2d` (w a
    (KH, KW, C, F) tensor or a :class:`~repro_torch.sparse.conv.
    PlannedConv`)."""
    st = _site_of(w, site)
    return scv.conv2d(x, w, stride, name=st.name,
                      collect_stats=collect_stats, **resolve(st, cfg))


def project(x, w, site: Optional[OpSite], cfg, *, n_contract: int = 1,
            plan_act=None, collect_stats: bool = False):
    """Site-resolved :func:`repro_torch.sparse.dispatch.project`."""
    st = _site_of(w, site)
    return dsp.project(x, w, n_contract=n_contract, plan_act=plan_act,
                       name=st.name, collect_stats=collect_stats,
                       **resolve(st, cfg))
