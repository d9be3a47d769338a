"""Invariant validators for the sparse data structures (the JAX package's
``sparse/validate.py``).

Cheap, composable checks over the structures the dispatch layer and the
serving engine trust:

* :func:`check_sparse_activation` — ``SparseActivation`` metadata is
  self-consistent (slice activity is the bitmap reduced at ``slice_k``);
  ``strict=True`` also requires the bitmap to cover every non-zero value
  (true for relu-family activations; KV score operands carry a bitmap
  that is a subset of the non-zeros, see ``kvcache.score_operand``).
* :func:`check_planned_weight` — a ``PlannedWeight``'s cached slice /
  element activity has the right shapes and, with ``values=True``,
  *covers* the value-derived activity (a dead slice marked active only
  schedules wasted work; the reverse would skip real contributions).
* :func:`check_schedule` — front-pack / stable-partition schedules never
  reference inactive positions in their counted prefix, counts match the
  activity, and the packed prefix is strictly ascending.
* :func:`check_paged_kv` / :func:`check_kv` — cache occupancy ``blk`` is
  the popcount of the occupancy bitmap per block, and per-slot occupancy
  equals ``min(pos, window)``.
* :func:`check_tuning_cache` — every cache entry still satisfies
  ``plan.knobs_valid`` at its bucket geometry.

All validators raise :class:`ValidationError`.  Enable the
dispatch-boundary checks with ``REPRO_VALIDATE=1`` (read at import and by
:func:`reset`, where the JAX package reads it on every call),
:func:`enable` or ``RunConfig.validate``.  PyTorch runs eagerly, so every operand is
concrete (:func:`is_concrete` is always True; the JAX package skips
traced values).
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, List, Optional

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.sparse import plan as pln
from repro_torch.sparse.activation import SparseActivation
from repro_torch.sparse.weights import PlannedWeight


class ValidationError(AssertionError):
    """A sparse-structure invariant does not hold."""


# ---------------------------------------------------------------------------
# enablement: ``REPRO_VALIDATE`` read once (at import and by ``reset``),
# not on every dispatch call; programmatically forceable


def _from_env() -> bool:
    return os.environ.get("REPRO_VALIDATE", "") not in ("", "0")


_ON: bool = _from_env()


def enabled() -> bool:
    """True when dispatch-boundary validation should run."""
    return _ON


def enable(on: bool = True) -> None:
    """Force validation on/off regardless of ``REPRO_VALIDATE``."""
    global _ON
    _ON = bool(on)


def reset() -> None:
    """Return to env-driven enablement, re-reading ``REPRO_VALIDATE``."""
    global _ON
    _ON = _from_env()


@contextlib.contextmanager
def enabled_within(on: bool = True) -> Iterator[None]:
    """Scope validation on (or off) for a ``with`` block."""
    global _ON
    prev = _ON
    _ON = bool(on)
    try:
        yield
    finally:
        _ON = prev


def is_concrete(*arrays) -> bool:
    """True: PyTorch tensors are always concrete."""
    return True


def _np(x) -> np.ndarray:
    """A host copy of a tensor (bool/int as they are; int32 bit-pattern
    words stay int32)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fail(what: str, msg: str):
    raise ValidationError(f"{what}: {msg}")


# ---------------------------------------------------------------------------
# SparseActivation / PlannedWeight


def check_sparse_activation(sa: SparseActivation, *, strict: bool = False,
                            what: str = "SparseActivation") -> None:
    """Bitmap ⇔ slice-activity (and optionally values) consistency.

    Non-strict (the dispatch-boundary default) checks the metadata: the
    shapes line up and ``slice_act`` is the element bitmap reduced at
    ``slice_k``.  ``strict=True`` also requires every non-zero value to be
    covered by the bitmap.
    """
    k = sa.values.shape[-1]
    words = -(-k // 32)
    lead = tuple(sa.values.shape[:-1])
    if tuple(sa.bitmap.shape) != (*lead, words):
        _fail(what, f"bitmap shape {tuple(sa.bitmap.shape)} != "
                    f"{(*lead, words)} for K={k}")
    s = -(-k // sa.slice_k)
    if tuple(sa.slice_act.shape) != (*lead, s):
        _fail(what, f"slice_act shape {tuple(sa.slice_act.shape)} != "
                    f"{(*lead, s)} for K={k} slice_k={sa.slice_k}")
    mask = sa.element_mask()
    want = _np(pln.slice_activity_lhs(mask, sa.slice_k))
    got = _np(sa.slice_act)
    if not np.array_equal(got, want):
        bad = int(np.sum(got != want))
        _fail(what, f"slice_act disagrees with the bitmap at {bad} "
                    f"slice position(s) (slice_k={sa.slice_k})")
    if strict:
        stray = (sa.values != 0) & ~mask
        if bool(stray.any()):
            _fail(what, f"{int(stray.sum())} non-zero value(s) fall "
                        "outside the bitmap (strict mode)")


def check_planned_weight(w: PlannedWeight, *, values: bool = False,
                         what: str = "PlannedWeight") -> None:
    """PlannedWeight metadata shapes (+ optional value coverage).

    Shapes are always checked: ``slice_act`` is ``(S, N)`` (or
    ``(E, S, N)``) at ``S = ceil(K / slice_k)``, ``elem_act`` ``(K, Nt)``
    at its block_n.  ``values=True`` also requires the cached activity to
    *cover* the value-derived activity — an equality for
    :func:`plan_weight` plans; opt-in because the KV decode's value
    operand reads a recycled page pool whose unwritten blocks may hold
    stale non-zeros (correctness there comes from the probabilities'
    zeros).
    """
    arr = w.w
    if arr.ndim not in (2, 3):
        _fail(what, f"weights must be 2-D or 3-D, got {tuple(arr.shape)}")
    s = -(-arr.shape[-2] // w.slice_k)
    want = (*arr.shape[:-2], s, arr.shape[-1])
    if tuple(w.slice_act.shape) != want:
        _fail(what, f"slice_act shape {tuple(w.slice_act.shape)} != "
                    f"{want} for K={arr.shape[-2]} slice_k={w.slice_k}")
    if w.elem_act is not None and w.elem_block_n:
        nt = -(-arr.shape[-1] // w.elem_block_n)
        ewant = (*arr.shape[:-2], arr.shape[-2], nt)
        if tuple(w.elem_act.shape) != ewant:
            _fail(what, f"elem_act shape {tuple(w.elem_act.shape)} != "
                        f"{ewant} at block_n={w.elem_block_n}")
    if not values:
        return
    derived = pln.slice_activity_rhs(arr, w.slice_k)
    uncovered = derived & ~w.slice_act.to(torch.bool)
    if bool(uncovered.any()):
        _fail(what, f"{int(uncovered.sum())} k-slice(s) with non-zero "
                    "weights are marked inactive in slice_act")
    if w.elem_act is not None and w.elem_block_n:
        ed = pln.element_activity_rhs(arr, w.elem_block_n)
        euncov = ed & ~w.elem_act.to(torch.bool)
        if bool(euncov.any()):
            _fail(what, f"{int(euncov.sum())} element(s) with non-zero "
                        "weights are marked inactive in elem_act")


# ---------------------------------------------------------------------------
# schedules


def check_schedule(ks, counts, act, *, tail: str = "repeat_last",
                   what: str = "schedule") -> None:
    """Front-pack / stable-partition schedule invariants.

    For every fiber: ``counts`` equals the number of active positions, the
    first ``counts`` scheduled indices are strictly ascending and all
    reference *active* positions, and — for ``tail="repeat_last"``
    (``plan.front_pack``) — the padded tail repeats the last active index
    (0 when the fiber is empty).  ``tail="partition"``
    (``plan.stable_partition``) instead requires the schedule to be a
    permutation of ``range(S)``.
    """
    ks = _np(ks).astype(np.int64)
    counts = _np(counts).astype(np.int64)
    act = _np(act).astype(bool)
    s = act.shape[-1]
    if ks.shape[-1] != s:
        _fail(what, f"schedule width {ks.shape[-1]} != activity {s}")
    fks = ks.reshape(-1, s)
    fc = counts.reshape(-1)
    fact = act.reshape(-1, s)
    if fks.shape[0] != fc.shape[0] or fc.shape[0] != fact.shape[0]:
        _fail(what, f"fiber counts disagree: ks {fks.shape}, "
                    f"counts {fc.shape}, act {fact.shape}")
    if not np.array_equal(fc, fact.sum(-1)):
        _fail(what, "counts != number of active positions")
    if fks.size and (fks.min() < 0 or fks.max() >= s):
        _fail(what, f"scheduled index out of range 0..{s - 1}")
    within = np.arange(s)[None, :] < fc[:, None]
    hit = np.take_along_axis(fact, fks, axis=-1)
    if np.logical_and(within, ~hit).any():
        _fail(what, "counted prefix schedules an inactive position")
    asc = np.diff(fks, axis=-1) > 0
    if np.logical_and(within[:, 1:], ~asc).any():
        _fail(what, "counted prefix is not strictly ascending")
    if tail == "repeat_last":
        rows = np.arange(fks.shape[0])
        last = fks[rows, np.maximum(fc - 1, 0)]
        want_tail = np.where(fc > 0, last, 0)[:, None]
        bad = np.logical_and(~within, fks != want_tail)
        if bad.any():
            _fail(what, "padded tail does not repeat the last active "
                        "index")
    elif tail == "partition":
        perm = np.sort(fks, axis=-1)
        if not np.array_equal(perm, np.broadcast_to(np.arange(s),
                                                    fks.shape)):
            _fail(what, "schedule is not a permutation of range(S)")
    else:
        raise ValueError(f"unknown tail mode {tail!r}")


# ---------------------------------------------------------------------------
# KV caches


def _popcount_check(occ_words, blk, capacity: int, block_t: int,
                    what: str) -> np.ndarray:
    """blk == per-block popcount of the occupancy bitmap; returns the
    unpacked (…, capacity) bool mask for further checks."""
    mask = _np(bm.unpack_bits(occ_words, axis=-1))[..., :capacity]
    want = mask.reshape(*mask.shape[:-1], capacity // block_t,
                        block_t).sum(-1)
    got = _np(blk)
    if not np.array_equal(got, want):
        bad = int(np.sum(got != want))
        _fail(what, f"blk != popcount(occ) at {bad} block(s)")
    if got.size and (got.min() < 0 or got.max() > block_t):
        _fail(what, f"blk outside 0..{block_t}")
    return mask


def check_kv(cache, *, what: str = "SparseKVCache") -> None:
    """Contiguous sparse KV cache: occupancy == popcount per block."""
    _popcount_check(cache.occ, cache.blk, cache.capacity, cache.block_t,
                    what)


def check_paged_kv(cache, *, table=None,
                   what: str = "PagedSparseKVCache") -> None:
    """Paged cache invariants.

    * ``blk`` is the per-page popcount of the occupancy bitmap.
    * Per-slot occupancy equals ``min(pos, window)`` (the ring never
      loses or invents written slots).
    * Block-table entries are in range, and — when the authoritative host
      ``table`` is given — every real (non-trash) page is mapped by at
      most one slot.  The device table is checked for range only (it may
      lag the host copy by one push).
    """
    c = cache
    mask = _popcount_check(c.occ, c.blk, c.capacity, c.page_size, what)
    pos = _np(c.pos)
    window = np.asarray(c.window)
    occupied = mask.sum(-1)
    want = np.minimum(np.minimum(pos, window), c.capacity)
    if not np.array_equal(occupied, np.broadcast_to(want,
                                                    occupied.shape)):
        _fail(what, f"per-slot occupancy {occupied.tolist()} != "
                    f"min(pos, window) {np.ravel(want).tolist()}")
    dev = _np(c.table)
    if dev.size and (dev.min() < 0 or dev.max() > c.n_pages):
        _fail(what, f"device table entry outside 0..{c.n_pages}")
    if table is not None:
        t = _np(table)
        if t.size and (t.min() < 0 or t.max() > c.n_pages):
            _fail(what, f"host table entry outside 0..{c.n_pages}")
        mapped = t[t > 0]
        if mapped.size != np.unique(mapped).size:
            _fail(what, "a physical page is mapped by more than one "
                        "slot/block")


# ---------------------------------------------------------------------------
# allocator + tuning cache


def check_allocator(alloc, *, what: str = "PageAllocator") -> None:
    """Free-list uniqueness / range (delegates to ``alloc.check()``)."""
    try:
        alloc.check()
    except AssertionError as e:
        _fail(what, str(e))


def check_tuning_cache(cache=None, *, interpret: Optional[bool] = None,
                       what: str = "TuningCache") -> List[str]:
    """Every cache entry satisfies ``plan.knobs_valid`` at its bucket
    geometry, under its platform's rules (``"cpu"`` keys the CPU's,
    others the card's; ``interpret`` forces one).  Returns the checked
    keys."""
    from repro_torch.sparse import autotune as atn

    if cache is None:
        cache = atn.get_cache()
    checked = []
    for key, entry in cache.entries.items():
        parts = key.split("|")
        if len(parts) < 7:
            _fail(what, f"malformed key {key!r}")
        platform, dtype_name = parts[0], parts[1]
        try:
            dims = {p[0]: int(p[1:]) for p in parts[3:6]}
            kn = cache.get(key)
        except (ValueError, KeyError, TypeError) as e:
            _fail(what, f"unparseable entry {key!r}: {e}")
        interp = (platform == "cpu") if interpret is None else interpret
        if kn.backend not in atn.BACKENDS:
            _fail(what, f"{key!r}: unknown backend {kn.backend!r}")
        if not kn.valid_for(dims["m"], dims["n"], dims["k"],
                            interpret=interp,
                            dtype_bytes=atn._DTYPE_BYTES.get(
                                dtype_name, 4),
                            grouped=len(parts) > 7):
            _fail(what, f"{key!r}: knobs {entry} violate "
                        "plan.knobs_valid at their bucket geometry")
        checked.append(key)
    return checked


# ---------------------------------------------------------------------------
# dispatch boundary + misc


def check_operands(*operands) -> None:
    """Validate any sparse operands among ``operands`` (the dispatch
    boundary hook; plain tensors pass through)."""
    for x in operands:
        if isinstance(x, SparseActivation):
            check_sparse_activation(x)
        elif isinstance(x, PlannedWeight):
            check_planned_weight(x)


def check_finite(x, what: str = "array") -> None:
    """All-finite check."""
    arr = x.values if isinstance(x, SparseActivation) else x
    finite = torch.isfinite(torch.as_tensor(arr))
    if not bool(finite.all()):
        _fail(what, f"{int((~finite).sum())} non-finite element(s)")
