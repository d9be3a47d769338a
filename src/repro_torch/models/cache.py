"""KV caches for serving (plain bf16; no int8 quantisation).

One :class:`KVCache` per layer, ``(B, T, KV, hd)`` buffers; a decoder
layer of an encoder-decoder holds an :class:`EncDecCache`, its
self-attention cache beside a cross cache of ``encoder_len`` slots that
the prefill fills from the memory and decode only reads.  Ring
semantics as in the JAX package: the token at absolute position p lives
in slot ``p mod window``.  Unlike the JAX package, :func:`update` writes
into the buffers in place (a full-width cache is large) and returns a
cache with the advanced cursor.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple, Union

import torch

Cursor = Union[int, torch.Tensor]   # one shared cursor, or (B,) per row


@dataclasses.dataclass(frozen=True)
class KVCache:
    k: torch.Tensor     # (B, T, KV, hd)
    v: torch.Tensor
    pos: int            # number of tokens written
    window: int         # ring size; == T means a full cache

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]


class EncDecCache(NamedTuple):
    """The caches of one encoder-decoder decoder layer."""
    kv: KVCache         # self-attention
    cross_kv: KVCache   # cross-attention over the encoder memory


def init_cache(batch: int, capacity: int, n_kv: int, hd: int, *,
               dtype=torch.bfloat16, window: int = 0,
               device=None) -> KVCache:
    shape = (batch, capacity, n_kv, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=0, window=window or capacity)


def update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor
           ) -> KVCache:
    """Write S new tokens (k_new: (B, S, KV, hd)) at the ring cursor.

    S >= capacity keeps only the newest ``capacity`` tokens (a roll);
    otherwise a modular scatter (wrap-around mid-stream included).
    """
    s = k_new.shape[-3]
    cap = cache.capacity
    for buf, upd in ((cache.k, k_new), (cache.v, v_new)):
        upd = upd.to(buf.dtype)
        if s >= cap:
            shift = (cache.pos + s - cap) % cache.window
            buf.copy_(torch.roll(upd[:, s - cap:], shift, dims=1))
        else:
            slots = (cache.pos + torch.arange(s, device=buf.device)) \
                % cache.window
            buf[:, slots] = upd
    return dataclasses.replace(cache, pos=cache.pos + s)


def written_slot_mask(pos: Cursor, window: int, capacity: int, s: int,
                      device=None) -> torch.Tensor:
    """(capacity,) bool: the slots an :func:`update` of ``s`` tokens at
    ring cursor ``pos`` writes; a (B,) tensor of per-row cursors (the
    paged serving cache) gives (B, capacity).  Closed form of its
    placement: only the newest ``min(s, window)`` tokens survive, at slots
    ``(pos + s - n + j) mod window``.  Ring metadata only; no buffer is
    read."""
    pos, device = _cursor(pos, device)
    slots = torch.arange(capacity, device=device)
    n = min(s, window)
    start = (pos + s - n) % window
    return (slots < window) & (((slots - start) % window) < n)


def key_positions_at(pos: Cursor, window: int, capacity: int,
                     device=None) -> torch.Tensor:
    """Absolute token position held in each slot (-1 = empty): slot i
    holds the newest p < pos with p ≡ i (mod window).  ``pos`` is an int,
    or a (B,) tensor of per-row cursors, which gives (B, capacity)."""
    pos, device = _cursor(pos, device)
    slots = torch.arange(capacity, device=device)
    last = pos - 1
    kpos = last - ((last - slots) % window)
    return torch.where((slots < window) & (kpos >= 0) & (pos > 0), kpos, -1)


def _cursor(pos: Cursor, device):
    """An int cursor as it is; a (B,) cursor tensor as (B, 1), on its own
    device, to broadcast against the slot axis."""
    if isinstance(pos, torch.Tensor):
        return pos[..., None], pos.device
    return pos, device


def key_positions(cache: KVCache) -> torch.Tensor:
    return key_positions_at(cache.pos, cache.window, cache.capacity,
                            cache.k.device)


def read(cache: KVCache, dtype=torch.bfloat16
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(k, v, key_positions) with k and v cast to ``dtype``."""
    return cache.k.to(dtype), cache.v.to(dtype), key_positions(cache)
