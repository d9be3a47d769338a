"""Sparse KV cache: bitmap-scheduled attention decode.

At a decode step most of a long-context cache is slots that were never
written (the allocated context is larger than the live one) or that a
sliding window hides.  :class:`SparseKVCache` is a
:class:`~repro_torch.models.cache.KVCache` plus a packed per-slot
occupancy bitmap and per-block written counts, kept up to date by
:func:`update` from the ring arithmetic alone (prefill, decode append and
ring wrap are one closed form) — never from the K/V values.

The decode path (``attention.attend_sparse``) ANDs occupancy with the
causal/window mask (:func:`repro_torch.sparse.plan.kv_decode_slots`) and
sends both attention products through the grouped dispatch as E = batch ×
KV-head stacked problems:

* score — ``scoresᵀ[e] = K[e] @ qᵀ[e]``: cache slots are the *rows*, so
  unscheduled blocks are block-rows of a
  :class:`~repro_torch.sparse.activation.SparseActivation` whose metadata
  comes from the schedule (:func:`score_operand`);
* value — ``out[e] = p[e] @ V[e]``: cache slots are the *contraction*, so
  unwritten blocks are zero k-slices of a
  :class:`~repro_torch.sparse.weights.PlannedWeight` planned from
  occupancy, and masked probabilities ride the activation side
  (:func:`value_operands`).

The occupancy words are int32 bit patterns, as in
:mod:`repro_torch.core.bitmap`.  One bitmap per layer serves every batch
row: all rows share the cursor.  Both caches, and the paged pool, may be
int8 with per-(token, head) scales (``quantized=True``), as
:mod:`repro_torch.models.cache` quantises them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import bitmap as bm
from repro_torch.models import cache as kvc
from repro_torch.sparse import plan as pln
from repro_torch.sparse.activation import SparseActivation, sparsify
from repro_torch.sparse.weights import PlannedWeight


@dataclasses.dataclass(frozen=True)
class SparseKVCache(kvc.KVCache):
    """A :class:`~repro_torch.models.cache.KVCache` plus occupancy.

    occ : (ceil(capacity/32),) int32 packed slot-occupancy bitmap: slot i
          is 1 iff a token was ever written there.
    blk : (NB,) int32 occupied slots per cache block; the block size is
          implied by the shapes (:attr:`block_t`).
    """
    occ: torch.Tensor
    blk: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return self.blk.shape[-1]

    @property
    def block_t(self) -> int:
        """Slots per occupancy block: ceil(capacity / NB), which maps the
        NB that :func:`init_sparse_cache` stores back to itself."""
        return -(-self.capacity // self.n_blocks)


def occupancy_mask(cache: SparseKVCache) -> torch.Tensor:
    """(capacity,) bool per-slot occupancy from the packed bitmap."""
    return bm.unpack_bits(cache.occ, axis=-1)[..., :cache.capacity]


def init_sparse_cache(batch: int, capacity: int, n_kv: int, hd: int, *,
                      dtype=torch.bfloat16, quantized: bool = False,
                      window: int = 0, block_t: int = 32,
                      device=None) -> SparseKVCache:
    """A zero-occupancy sparse cache (the geometry of ``init_cache``)."""
    base = kvc.init_cache(batch, capacity, n_kv, hd, dtype=dtype,
                          quantized=quantized, window=window, device=device)
    nb = -(-capacity // max(1, block_t))
    return SparseKVCache(
        k=base.k, v=base.v, pos=base.pos, window=base.window,
        k_scale=base.k_scale, v_scale=base.v_scale,
        occ=bm.pack_bits_padded(torch.zeros(capacity, dtype=torch.bool,
                                            device=device)),
        blk=torch.zeros(nb, dtype=torch.int32, device=device))


def _blocked(mask: torch.Tensor, block_t: int) -> torch.Tensor:
    """(..., T) slot mask → (..., NB, block_t) with a zero tail."""
    *lead, t = mask.shape
    nb = -(-t // block_t)
    return torch.nn.functional.pad(mask, (0, nb * block_t - t)).reshape(
        *lead, nb, block_t)


def update(cache: SparseKVCache, k_new: torch.Tensor, v_new: torch.Tensor
           ) -> SparseKVCache:
    """:func:`repro_torch.models.cache.update` (in place on the buffers)
    plus the occupancy: OR in the closed-form ring write mask."""
    written = kvc.written_slot_mask(cache.pos, cache.window, cache.capacity,
                                    k_new.shape[-3], device=cache.k.device)
    occ_slots = occupancy_mask(cache) | written
    blk = _blocked(occ_slots, cache.block_t).sum(-1, dtype=torch.int32)
    base = kvc.update(cache, k_new, v_new)
    return dataclasses.replace(base, occ=bm.pack_bits_padded(occ_slots),
                               blk=blk)


def occupancy_report(cache: SparseKVCache,
                     mask_window: Optional[int] = None) -> dict:
    """Host-side occupancy metrics of one cache.

    written_frac : occupied slots / capacity;
    evicted_frac : share of the written stream no longer attendable (ring
                   eviction, plus history beyond ``mask_window``, the
                   model's sliding window, when it is tighter);
    live_slots   : slots holding an attendable token.
    """
    ring = min(cache.pos, cache.window)
    live = min(cache.pos, ring if mask_window is None
               else min(ring, mask_window))
    evicted = max(cache.pos - live, 0)
    return {
        "written_frac": int(cache.blk.sum()) / cache.capacity,
        "evicted_frac": evicted / max(cache.pos, 1),
        "live_slots": live,
        "quantized": cache.quantized,
        "capacity": cache.capacity,
        "block_t": cache.block_t,
        "n_blocks": cache.n_blocks,
    }


# ---------------------------------------------------------------------------
# decode-step operands (consumed by attention.attend_sparse)
# ---------------------------------------------------------------------------

def score_operand(k_e: torch.Tensor, sched_slots: torch.Tensor,
                  slice_k: int) -> SparseActivation:
    """The score product's activation side: cache keys k_e (E, T, hd)
    with rows outside the schedule (T,) or (E, T) declared inactive —
    their scores are masked to -inf afterwards, so a kernel may skip
    them."""
    if sched_slots.ndim == 1:
        sched_slots = sched_slots[None, :]
    mask = sched_slots[..., None].expand(k_e.shape)
    return sparsify(k_e, mask=mask, slice_k=slice_k)


def value_operands(occ_slots: torch.Tensor, p: torch.Tensor,
                   v_e: torch.Tensor, sched_slots: torch.Tensor,
                   block_t: int) -> Tuple[SparseActivation, PlannedWeight]:
    """(p, V) for the value product ``out[e] = p[e] @ V[e]``.

    V's unwritten blocks are zero k-slices (weight side, from occupancy);
    probabilities outside the schedule, zeroed by the softmax mask, ride
    the activation side, so the AND skips both.  occ_slots / sched_slots:
    (T,) shared or (E, T) per problem.
    """
    if occ_slots.ndim == 1:
        occ_slots = occ_slots[None, :]
    if sched_slots.ndim == 1:
        sched_slots = sched_slots[None, :]
    occ_blocks = pln.slot_block_reduce(occ_slots, block_t)
    w_act = occ_blocks[..., None].expand(v_e.shape[0], occ_blocks.shape[-1],
                                         v_e.shape[-1])
    w = PlannedWeight(w=v_e, slice_act=w_act, slice_k=block_t)
    p_mask = sched_slots[:, None, :].expand(p.shape)
    return sparsify(p, mask=p_mask, slice_k=block_t), w


# ---------------------------------------------------------------------------
# the paged pool (the continuous-batching engine's decode state)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagedSparseKVCache:
    """One layer's multi-slot KV cache: a physical page pool plus per-slot
    block tables.

    Every serving slot sees a *logical* cache of ``capacity`` slots; the
    K/V live in pages of ``page_size`` cache slots drawn from one pool
    shared by the slots and indexed through ``table``.  The page size is
    the occupancy block size (``ModelConfig.sparse_block_t`` by default),
    so a page's occupied count in ``blk`` is the decode schedule's block
    entry, and a page freed by one request is a block its next owner's
    occupancy re-covers (stale contents are never scheduled).

    Physical page 0 is the *trash page*: every unmapped table entry (all
    of an inactive slot's) points at it, so the batched decode write of
    an idle slot lands somewhere harmless without per-slot control flow.
    The allocator (:mod:`repro_torch.serving.scheduler`) hands out pages
    1..P.  Unlike the JAX package's pool there is no stacked layer axis.

    k/v    : (P+1, page, KV, hd) physical pool (bf16 or int8), written in
             place
    k_scale/
    v_scale: (P+1, page, KV, 1) float32 scales of an int8 pool; None for
             bf16
    pos    : (B,) int32 tokens written per slot
    window : logical ring size (== capacity: the engine retires a request
             before its cache wraps and applies a model window as a mask)
    table  : (B, NB) int32 physical page of each logical block
    occ    : (B, ceil(capacity/32)) int32 packed per-slot occupancy
    blk    : (B, NB) int32 occupied slots per logical block
    """
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    window: int
    table: torch.Tensor
    occ: torch.Tensor
    blk: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    @property
    def page_size(self) -> int:
        return self.k.shape[-3]

    @property
    def n_pages(self) -> int:
        """Allocatable pages (the trash page excluded)."""
        return self.k.shape[0] - 1

    @property
    def n_slots(self) -> int:
        return self.table.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.table.shape[1]

    @property
    def capacity(self) -> int:
        return self.n_blocks * self.page_size


def init_paged_cache(slots: int, pages: int, page_size: int, capacity: int,
                     n_kv: int, hd: int, *, dtype=torch.bfloat16,
                     quantized: bool = False,
                     device=None) -> PagedSparseKVCache:
    """Zero pool of ``pages`` usable pages plus the trash page (int8 with
    unit scales when ``quantized``), empty tables (every block → page 0).
    ``capacity`` must be a page multiple (the engine rounds it up)."""
    if capacity % page_size:
        raise ValueError(f"capacity {capacity} is not a multiple of the "
                         f"page size {page_size}")
    nb = capacity // page_size
    shape = (pages + 1, page_size, n_kv, hd)
    kv_dtype = torch.int8 if quantized else dtype

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)
    scales = ({} if not quantized else {
        name: torch.ones((*shape[:-1], 1), dtype=torch.float32,
                         device=device)
        for name in ("k_scale", "v_scale")})
    return PagedSparseKVCache(
        k=zeros(*shape, dtype=kv_dtype), v=zeros(*shape, dtype=kv_dtype),
        pos=zeros(slots), window=capacity, table=zeros(slots, nb),
        occ=bm.pack_bits_padded(zeros(slots, capacity, dtype=torch.bool)),
        blk=zeros(slots, nb), **scales)


def paged_occupancy_mask(cache: PagedSparseKVCache) -> torch.Tensor:
    """(B, capacity) bool per-slot occupancy from the packed bitmap."""
    return bm.unpack_bits(cache.occ, axis=-1)[..., :cache.capacity]


def paged_key_positions(cache: PagedSparseKVCache) -> torch.Tensor:
    """(B, capacity) absolute position held in each logical slot (-1
    empty)."""
    return kvc.key_positions_at(cache.pos, cache.window, cache.capacity)


def paged_view(cache: PagedSparseKVCache, scales: bool = False
               ) -> Tuple[torch.Tensor, ...]:
    """Gather the logical (B, capacity, KV, hd) K/V view of the pool
    through the block tables, in the pool's type (int8 stays int8); with
    ``scales``, an int8 pool's (B, capacity, KV, 1) scales follow.
    Blocks mapped to the trash page read stale values; every consumer
    masks by occupancy and visibility first."""
    b, nb = cache.table.shape

    def gather(pool):
        return pool[cache.table].reshape(b, nb * cache.page_size,
                                         *pool.shape[2:])
    if scales:
        return (gather(cache.k), gather(cache.v), gather(cache.k_scale),
                gather(cache.v_scale))
    return gather(cache.k), gather(cache.v)


def paged_read(cache: PagedSparseKVCache, dtype=torch.bfloat16
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The logical K/V view in ``dtype``: the block-table gather plus a
    cast, an int8 pool dequantised first as the decode branches of
    ``attention`` dequantise (:func:`~repro_torch.models.cache.dequantize`).
    The JAX package
    multiplies its unquantised pool by float32 scales of one and rounds
    back, which is exact, so the values are the same."""
    if cache.quantized:
        k, v, ks, vs = paged_view(cache, scales=True)
        return kvc.dequantize(k, ks, dtype), kvc.dequantize(v, vs, dtype)
    k, v = paged_view(cache)
    return k.to(dtype), v.to(dtype)


def paged_update(cache: PagedSparseKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> PagedSparseKVCache:
    """Batched single-token decode append across all slots, in place on
    the pool.

    k_new/v_new: (B, 1, KV, hd), quantised first in an int8 pool.  Each
    slot writes the page its table maps its ring cursor to; a slot whose
    block is unmapped (an inactive slot, or a cursor the host has not
    backed yet) writes the trash page, where several such slots may write
    the same offset — a harmless race.  Occupancy follows the closed-form
    ring mask, per slot.
    """
    if k_new.shape[-3] != 1:
        raise ValueError("paged caches take batched single-token appends")
    page = cache.page_size
    slot = cache.pos % cache.window                      # (B,)
    lb = (slot // page).long()
    off = (slot % page).long()
    pp = cache.table.gather(1, lb[:, None])[:, 0].long()
    for pool, upd in kvc.write_pairs(cache, k_new, v_new):
        pool[pp, off] = upd[:, 0]
    written = kvc.written_slot_mask(cache.pos, cache.window,
                                    cache.capacity, 1)
    occ_slots = paged_occupancy_mask(cache) | written
    blk = _blocked(occ_slots, page).sum(-1, dtype=torch.int32)
    return dataclasses.replace(cache, pos=cache.pos + 1,
                               occ=bm.pack_bits_padded(occ_slots), blk=blk)


def insert_prefill(cache: PagedSparseKVCache, pre: kvc.KVCache, row: int,
                   slot: int, pages: Sequence[int],
                   true_len: int) -> PagedSparseKVCache:
    """Copy row ``row`` of a full-history contiguous prefill cache ``pre``
    (B, Tc, KV, hd) into serving slot ``slot``, whose first ``len(pages)``
    logical blocks the host backed with physical ``pages``; the pool is
    written in place.

    All ``len(pages) * page`` slots are copied, the padding past
    ``true_len`` in the last page included (a shorter prefill is
    zero-padded); that padding is never scheduled, because occupancy is
    rebuilt from ``true_len``, never from values.
    """
    page = cache.page_size
    nbr = len(pages)
    need = nbr * page
    idx = torch.as_tensor(pages, dtype=torch.long, device=cache.k.device)
    pairs = [(cache.k, pre.k), (cache.v, pre.v)]
    if cache.quantized:
        pairs += [(cache.k_scale, pre.k_scale), (cache.v_scale, pre.v_scale)]
    for pool, src in pairs:
        r = src[row, :need]
        if r.shape[0] < need:
            r = torch.nn.functional.pad(r, (0, 0, 0, 0, 0, need - r.shape[0]))
        pool[idx] = r.reshape(nbr, page, *src.shape[-2:]).to(pool.dtype)
    # a fresh slot at cursor 0 with window == capacity: the ring mask is
    # the first true_len slots
    occ_row = torch.arange(cache.capacity, device=cache.occ.device) < true_len
    occ, pos, blk = cache.occ.clone(), cache.pos.clone(), cache.blk.clone()
    occ[slot] = bm.pack_bits_padded(occ_row)
    pos[slot] = true_len
    blk[slot] = _blocked(occ_row, page).sum(-1, dtype=torch.int32)
    return dataclasses.replace(cache, pos=pos, occ=occ, blk=blk)


def paged_occupancy_report(cache: PagedSparseKVCache,
                           mask_window: Optional[int] = None) -> dict:
    """Per-slot occupancy and pool mapping (host-side): the metrics of
    :func:`occupancy_report` per serving slot as lists, plus how many
    logical blocks are backed by real pages."""
    pos = [float(p) for p in cache.pos.tolist()]
    ring = [min(p, cache.window) for p in pos]
    live = [min(p, r if mask_window is None else min(r, mask_window))
            for p, r in zip(pos, ring)]
    occ = cache.blk.sum(-1).tolist()
    return {
        "written_frac": [o / cache.capacity for o in occ],
        "evicted_frac": [max(p - lv, 0.0) / max(p, 1.0)
                         for p, lv in zip(pos, live)],
        "live_slots": live,
        "mapped_blocks": [float(m)
                          for m in (cache.table > 0).sum(-1).tolist()],
        "capacity": cache.capacity,
        "block_t": cache.page_size,
        "quantized": cache.quantized,
        "n_blocks": cache.n_blocks,
        "n_pages": cache.n_pages,
    }
