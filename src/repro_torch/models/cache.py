"""KV caches for serving: bf16, or int8 with per-(token, head) scales.

One :class:`KVCache` per layer, ``(B, T, KV, hd)`` buffers; a decoder
layer of an encoder-decoder holds an :class:`EncDecCache`, its
self-attention cache beside a cross cache of ``encoder_len`` slots that
the prefill fills from the memory and decode only reads.  Ring
semantics as in the JAX package: the token at absolute position p lives
in slot ``p mod window``.  Unlike the JAX package, :func:`update` writes
into the buffers in place (a full-width cache is large) and returns a
cache with the advanced cursor.

An int8 cache (``init_cache(..., quantized=True)``) stores symmetric
per-(token, head) codes, absmax / 127 as the scale (:func:`_quantize`),
which halves the cache's bytes; :func:`read` dequantises the whole cache,
``attention.attend`` one KV chunk at a time.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch

Cursor = Union[int, torch.Tensor]   # one shared cursor, or (B,) per row


@dataclasses.dataclass(frozen=True)
class KVCache:
    k: torch.Tensor     # (B, T, KV, hd)
    v: torch.Tensor
    pos: int            # number of tokens written
    window: int         # ring size; == T means a full cache
    # (B, T, KV, 1) float32 scales of an int8 cache; None for bf16
    k_scale: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        kw_only=True)
    v_scale: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        kw_only=True)

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8


class EncDecCache(NamedTuple):
    """The caches of one encoder-decoder decoder layer."""
    kv: KVCache         # self-attention
    cross_kv: KVCache   # cross-attention over the encoder memory


def init_cache(batch: int, capacity: int, n_kv: int, hd: int, *,
               dtype=torch.bfloat16, quantized: bool = False,
               window: int = 0, device=None) -> KVCache:
    """Zero buffers; int8 ones with unit float32 scales when
    ``quantized``."""
    shape = (batch, capacity, n_kv, hd)
    kv_dtype = torch.int8 if quantized else dtype
    scales = ({} if not quantized else {
        name: torch.ones((*shape[:-1], 1), dtype=torch.float32,
                         device=device)
        for name in ("k_scale", "v_scale")})
    return KVCache(k=torch.zeros(shape, dtype=kv_dtype, device=device),
                   v=torch.zeros(shape, dtype=kv_dtype, device=device),
                   pos=0, window=window or capacity, **scales)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of ``x`` over its last axis and their float32
    scales (..., 1): absmax (at least 1e-6) / 127; the codes are
    ``x / scale`` in float32, rounded half to even, clipped to ±127."""
    scale = x.abs().amax(-1, keepdim=True).to(torch.float32)
    # divided by a tensor, not a Python number: CUDA multiplies by the
    # reciprocal of a number, one rounding off the quotient at times
    scale = torch.clamp(scale, min=1e-6) / scale.new_tensor(127.0)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize(x: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """int8 codes times their scales in ``dtype``, as the JAX package's
    decode branches dequantise: both factors in bf16, their product cast
    to ``dtype``.  The product of an int8 code and a bf16 scale is exact
    in float32, so it is formed there: for bf16 that is the bf16 multiply,
    for float32 it is what XLA computes for it in a compiled (scanned or
    jitted) function, which keeps the product unrounded."""
    return (x.to(torch.bfloat16).to(torch.float32)
            * scale.to(torch.bfloat16).to(torch.float32)).to(dtype)


def write_pairs(cache, k_new: torch.Tensor, v_new: torch.Tensor):
    """The (buffer, update) pairs one write of ``k_new``/``v_new`` puts
    into ``cache`` (a :class:`KVCache` or a paged pool): the values cast
    to the buffers' type, or, for an int8 cache, their codes and
    scales."""
    if not cache.quantized:
        return ((cache.k, k_new.to(cache.k.dtype)),
                (cache.v, v_new.to(cache.v.dtype)))
    kq, ks = _quantize(k_new)
    vq, vs = _quantize(v_new)
    return ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
            (cache.v_scale, vs))


def update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor
           ) -> KVCache:
    """Write S new tokens (k_new: (B, S, KV, hd)) at the ring cursor,
    quantised first in an int8 cache.

    S >= capacity keeps only the newest ``capacity`` tokens (a roll);
    otherwise a modular scatter (wrap-around mid-stream included).
    """
    s = k_new.shape[-3]
    cap = cache.capacity
    for buf, upd in write_pairs(cache, k_new, v_new):
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
    """(k, v, key_positions) with k and v in ``dtype``; an int8 cache is
    dequantised in float32 first, as the JAX package's ``read`` does."""
    if cache.quantized:
        return ((cache.k.to(torch.float32) * cache.k_scale).to(dtype),
                (cache.v.to(torch.float32) * cache.v_scale).to(dtype),
                key_positions(cache))
    return cache.k.to(dtype), cache.v.to(dtype), key_positions(cache)
