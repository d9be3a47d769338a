"""Declarative per-call-site dispatch resolution.

:class:`OpSite` names one sparse call site — its op kind, its tape name
and the logical axes of its weight.  Layers build sites once through the
memoized :func:`make`; :func:`resolve` turns a site and a ``ModelConfig``
into the dispatch knobs.  Only the config tier is ported: the knobs are
the config's ``sparse_*`` constants (no tuning cache, no cost model).

A kernel failure is not caught here: on the card it has to surface.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from repro_torch.sparse import dispatch as dsp

OPS = ("matmul",)


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One declarative sparse call site (hashable).

    op   : op kind — one of :data:`OPS`.
    name : stats-tape entry name (``mlp.up``, ``attn.q``, …).
    axes : logical names of the weight's axes (``("embed", "mlp")``, …).
    """
    op: str
    name: str
    axes: Tuple[str, ...] = ()


@functools.lru_cache(maxsize=None)
def make(op: str, name: str, *, axes: Tuple[str, ...] = ()) -> OpSite:
    """Memoized :class:`OpSite` constructor."""
    if op not in OPS:
        raise ValueError(f"OpSite op must be one of {OPS}, got {op!r}")
    return OpSite(op=op, name=name, axes=tuple(axes))


def resolve(st: OpSite, cfg) -> dict:
    """Site + config → dispatch knobs (the config constants)."""
    del st  # every ported site reads the same constants
    return dict(mode=cfg.sparse_mode, block_m=cfg.sparse_block_m,
                block_n=cfg.sparse_block_n, slice_k=cfg.sparse_slice_k,
                use_kernel=cfg.sparse_use_kernel,
                condense="k" if cfg.sparse_kcondense else None)


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


def project(x, w, site: Optional[OpSite], cfg, *, n_contract: int = 1,
            plan_act=None, collect_stats: bool = False):
    """Site-resolved :func:`repro_torch.sparse.dispatch.project`."""
    st = _site_of(w, site)
    return dsp.project(x, w, n_contract=n_contract, plan_act=plan_act,
                       name=st.name, collect_stats=collect_stats,
                       **resolve(st, cfg))
