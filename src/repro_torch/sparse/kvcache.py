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
row: all rows share the cursor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
                      dtype=torch.bfloat16, window: int = 0,
                      block_t: int = 32, device=None) -> SparseKVCache:
    """A zero-occupancy sparse cache (the geometry of ``init_cache``)."""
    base = kvc.init_cache(batch, capacity, n_kv, hd, dtype=dtype,
                          window=window, device=device)
    nb = -(-capacity // max(1, block_t))
    return SparseKVCache(
        k=base.k, v=base.v, pos=base.pos, window=base.window,
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
