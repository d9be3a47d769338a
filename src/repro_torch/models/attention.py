"""Attention: GQA with RoPE over a plain or sparse KV cache, and the
encoder-decoder's non-causal self-attention and cross-attention.

Grouped-query attention never materialises repeated KV heads (an explicit
group dim), and the softmax runs in float32.  ``Attention.forward`` is the
JAX package's ``attention_forward``, qkv biases and int8 caches included.
Long KV runs chunked (:func:`attend`'s ``chunk``): a running log-sum-exp
over KV chunks, a Python loop where the JAX package scans, which keeps the
scores O(Sq·chunk) and dequantises an int8 cache one chunk at a time.
Decode over a :class:`~repro_torch.sparse.kvcache.SparseKVCache`, or
over the serving engine's paged pool, in a sparse mode runs
:func:`attend_sparse`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cache as kvc
from repro_torch.sparse import kvcache as skvc
from repro_torch.sparse import plan as pln
from repro_torch.sparse import site

NEG_INF = -1e30
# the query position of a non-causal query: past every key
NOT_CAUSAL = 2 ** 30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs   # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, style: str,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) shared or (B, S) per-row
    absolute token positions (the multi-slot batched decode)."""
    if style == "none":
        return x
    hd = x.shape[-1]
    rot = hd if style == "half" else hd // 2   # chatglm "2d": half the dims
    cos, sin = _rope_angles(positions, rot, theta)   # (S|B,S, rot/2)
    if positions.ndim == 1:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


# ---------------------------------------------------------------------------
# core attention (grouped, masked)
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, qpos, kpos, window):
    """Unnormalised attention over one KV block.

    q: (B, Sq, KV, G, hd); k/v: (B, Skv, KV, hd); qpos (Sq,) / kpos (Skv,)
    absolute positions (-1 = invalid slot), each optionally batched with a
    (B, ·) leading dim (the per-slot serving decode).  Returns (acc
    (B,Sq,KV,G,hd) f32, row max m, row sumexp l), the last two (B, Sq, KV,
    G).
    """
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                          k.to(torch.float32))
    scores.mul_(q.shape[-1] ** -0.5)
    kp = kpos[..., None, :]
    qp = qpos[..., :, None]
    valid = (kp >= 0) & (kp <= qp)
    if window is not None:
        valid &= kp > (qp - window)
    # (1|B, 1, 1, Sq, Skv); the score-sized temporaries are updated in
    # place, so a long prefill's chunk holds two of them at most
    hidden = ~(valid[:, None, None] if valid.ndim == 3
               else valid[None, None, None])
    scores.masked_fill_(hidden, NEG_INF)
    m = scores.amax(-1)                          # (B, KV, G, Sq)
    e = torch.exp(scores.sub_(m[..., None]))
    del scores
    e.masked_fill_(hidden, 0.0)
    l = e.sum(-1)
    acc = torch.einsum("bkgqs,bskd->bqkgd", e, v.to(torch.float32))
    return acc, m.movedim(3, 1), l.movedim(3, 1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           qpos: torch.Tensor, kpos: torch.Tensor,
           window: Optional[int] = None, chunk: int = 0,
           k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked GQA attention.  q: (B,Sq,H,hd), k/v: (B,Skv,KVH,hd).

    ``chunk`` > 0 with Skv > chunk and Skv a multiple of it runs a running
    log-sum-exp over the KV chunks (scores O(Sq·chunk) instead of
    O(Sq·Skv)); otherwise one block.  k/v may be int8 with per-(token,
    head) ``k_scale``/``v_scale`` (B, Skv, KVH, 1): each chunk is then
    dequantised on its own, so no full-precision copy of the cache is
    made.
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)

    def block(lo, hi):
        kb, vb = k[:, lo:hi], v[:, lo:hi]
        if k_scale is not None:
            kb = kvc.dequantize(kb, k_scale[:, lo:hi], q.dtype)
            vb = kvc.dequantize(vb, v_scale[:, lo:hi], q.dtype)
        return _attend_block(qg, kb, vb, qpos, kpos[..., lo:hi], window)

    if chunk and skv > chunk and skv % chunk == 0:
        acc = torch.zeros((b, sq, kvh, g, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for lo in range(0, skv, chunk):
            a2, m2, l2 = block(lo, lo + chunk)
            m_new = torch.maximum(m, m2)
            c1 = torch.exp(m - m_new)
            c2 = torch.exp(m2 - m_new)
            acc = acc * c1[..., None] + a2 * c2[..., None]
            l = l * c1 + l2 * c2
            m = m_new
            del a2
    else:
        acc, _, l = block(0, skv)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attend_sparse(q: torch.Tensor, cache, cfg: ModelConfig, *,
                  qpos: torch.Tensor, kpos: torch.Tensor,
                  window: Optional[int] = None) -> torch.Tensor:
    """Bitmap-scheduled decode attention over a ``SparseKVCache`` or a
    ``PagedSparseKVCache``.

    q: (B, 1, H, hd).  The masked-softmax GQA of :func:`attend`, with both
    products sent through the grouped dispatch as E = B·KV stacked
    problems, so the tape counts scheduled against skipped cache blocks
    and, with ``cfg.sparse_use_kernel``, K3 (K4 under kcondense) skips
    them:

    * score: ``scoresᵀ[e] = K[e] (T, hd) @ qᵀ[e] (hd, G)`` — cache slots
      are block-rows, scheduled by occupancy AND the causal/window mask
      (unscheduled rows are masked to -inf, so skipping them changes
      nothing);
    * value: ``out[e] = p[e] (G, T) @ V[e] (T, hd)`` — cache slots are
      the contraction; unwritten blocks are zero k-slices of V.

    Both accumulate in float32 (the sites pin ``out_dtype``), as dense
    attention does.  As in the JAX package, p stays float32 and the value
    is the float32 product of p and V; with the kernel on, K3/K4 read V as
    stored in bf16 and widen it in registers (no float32 copy of the
    cache), without it the dispatch casts V to float32 for one matmul.

    A paged cache is read through its block tables first (the logical
    per-slot view), and carries per-row positions: qpos (B, 1) and kpos
    (B, T) give each slot its own (B, T) schedule, expanded over the slot's
    KV heads to per-problem (E, T) metadata.
    """
    b, _, h, hd = q.shape
    t = cache.capacity
    kvh = cache.k.shape[-2]
    g = h // kvh
    ne = b * kvh

    # an int8 cache is dequantised as the dense decode branches do
    if isinstance(cache, skvc.PagedSparseKVCache):
        kd, vd = skvc.paged_read(cache, dtype=q.dtype)
        occ = skvc.paged_occupancy_mask(cache)           # (B, T)
    else:
        if cache.quantized:
            kd = kvc.dequantize(cache.k, cache.k_scale, q.dtype)
            vd = kvc.dequantize(cache.v, cache.v_scale, q.dtype)
        else:
            kd, vd, _ = kvc.read(cache, dtype=q.dtype)
        occ = skvc.occupancy_mask(cache)                 # (T,)
    k_e = kd.transpose(1, 2).reshape(ne, t, hd)
    v_e = vd.transpose(1, 2).reshape(ne, t, hd)
    q_e = q.reshape(b, kvh, g, hd).transpose(2, 3).reshape(ne, hd, g)

    # occupancy equals kpos >= 0, so the schedule is also the softmax mask
    sched = pln.kv_decode_slots(occ, kpos,
                                qpos[0] if qpos.ndim == 1 else qpos, window)
    if sched.ndim == 2:
        sched_e = sched[:, None, :].expand(b, kvh, t).reshape(ne, t)
        occ_e = occ[:, None, :].expand(b, kvh, t).reshape(ne, t)
    else:
        sched_e, occ_e = sched, occ
    # attn.score tiles slot rows at block_m, attn.value slices the slot
    # contraction at slice_k; both resolve before the operands are built,
    # which must carry metadata at the served tiles
    st_s = site.make("attn.score", "attn.score", out_dtype="float32")
    st_v = site.make("attn.value", "attn.value", out_dtype="float32")
    kw_s = site.resolve(st_s, cfg)
    kw_v = site.resolve(st_v, cfg)
    bt = pln.effective_slice_k(t, kw_v["slice_k"])
    sk_hd = pln.effective_slice_k(hd, kw_s["slice_k"])

    x_k = skvc.score_operand(k_e, sched_e, sk_hd)
    scores_t, _ = site.grouped_matmul(x_k, q_e, st_s, cfg, resolved=kw_s)
    scores = scores_t.reshape(b, kvh, t, g).transpose(2, 3)
    scores = scores[:, :, :, None, :] * (hd ** -0.5)     # (B,KV,G,1,T)

    valid = (sched[:, None, None, None, :] if sched.ndim == 2
             else sched[None, None, None, None, :])      # (B|1,1,1,1,T)
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(-1)
    e = torch.exp(scores - m[..., None])
    e = torch.where(valid, e, 0.0)
    l = e.sum(-1)                                        # (B,KV,G,1)

    p_e = e[:, :, :, 0, :].reshape(ne, g, t)
    x_p, w_v = skvc.value_operands(occ_e, p_e, v_e, sched_e, bt)
    acc_e, _ = site.grouped_matmul(x_p, w_v, st_v, cfg,
                                   resolved={**kw_v, "slice_k": bt})

    acc = acc_e.reshape(b, kvh, g, hd)[:, None]          # (B,1,KV,G,hd)
    l = l.permute(0, 3, 1, 2)                            # (B,1,KV,G)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig, name: str,
          n_contract: int = 1, plan_act=None) -> torch.Tensor:
    """``bsd,dhk->bshk`` (n_contract=1) / ``bshk,hkd->bsd``
    (n_contract=2): a plain matmul in dense mode, else through the
    sparse dispatch."""
    if cfg.sparse_mode == "dense":
        k_dims = w.shape[:n_contract]
        out_dims = w.shape[n_contract:]
        lead = x.shape[:x.ndim - n_contract]
        y = torch.matmul(x.reshape(*lead, -1), w.reshape(k_dims.numel(), -1))
        return y.reshape(*lead, *out_dims)
    axes = ("embed", "heads") if n_contract == 1 else ("heads", "embed")
    y, _ = site.project(x, w, site.make("matmul", name, axes=axes), cfg,
                        n_contract=n_contract, plan_act=plan_act)
    return y


class Attention(nn.Module):
    """Attention weights in the JAX layouts: wq (d, h, hd), wk/wv (d, kv,
    hd), wo (h, hd, d); with ``cfg.qkv_bias`` a self-attention (not
    ``cross``) adds biases bq (h, hd) and bk/bv (kv, hd)."""

    def __init__(self, cfg: ModelConfig, *, cross: bool = False,
                 device=None, dtype=None):
        super().__init__()
        hd, h, kv, d = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype), requires_grad=False)
        self.wq = param(d, h, hd)
        self.wk = param(d, kv, hd)
        self.wv = param(d, kv, hd)
        self.wo = param(h, hd, d)
        self.bias = cfg.qkv_bias and not cross
        if self.bias:
            self.bq = param(h, hd)
            self.bk = param(kv, hd)
            self.bv = param(kv, hd)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal weights of stddev d^-0.5 and zero biases, as the JAX
        package initialises them."""
        std = self.wq.shape[0] ** -0.5
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.normal_(0.0, std, generator=generator)
        if self.bias:
            for b in (self.bq, self.bk, self.bv):
                b.zero_()

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor,
                cache: Optional[kvc.KVCache] = None,
                plans: Optional[Dict] = None,
                kv_source: Optional[torch.Tensor] = None,
                is_cross: bool = False,
                causal: bool = True,
                update_cache: bool = True,
                chunk: int = 0
                ) -> Tuple[torch.Tensor, Optional[kvc.KVCache]]:
        """Projections + attend (+ cache write) + output: the JAX
        package's ``attention_forward``.

        Self-attention takes K/V from x, with RoPE (``causal=False`` is
        the encoder's: every query sees every key).  Cross-attention
        (``is_cross``, never causal, no RoPE) takes K/V from the memory
        ``kv_source``, written to the cross cache when ``update_cache``
        (prefill); at decode (``kv_source=None``, ``update_cache=False``)
        it projects no K/V and reads the cache.  x: (B, S, D); positions:
        (S,) absolute positions of x, or (B, S) per row (the paged decode
        over a :class:`~repro_torch.sparse.kvcache.PagedSparseKVCache`).
        ``chunk`` is :func:`attend`'s KV chunk.  Returns (y (B, S, D), the
        updated cache or None).
        """
        if is_cross:
            causal = False
            if kv_source is None and cache is None:
                raise ValueError("cross-attention needs the memory or a "
                                 "filled cross cache")
        plans = plans or {}
        q = _proj(x, self.wq.to(x.dtype), cfg, "attn.q",
                  plan_act=plans.get("wq"))
        if self.bias:
            q = q + self.bq.to(q.dtype)
        k = v = None
        if kv_source is not None or cache is None or update_cache:
            src = x if kv_source is None else kv_source
            k = _proj(src, self.wk.to(x.dtype), cfg, "attn.k",
                      plan_act=plans.get("wk"))
            v = _proj(src, self.wv.to(x.dtype), cfg, "attn.v",
                      plan_act=plans.get("wv"))
            if self.bias:
                k = k + self.bk.to(k.dtype)
                v = v + self.bv.to(v.dtype)
        if not is_cross:
            q = apply_rope(q, positions, cfg.rope_style, cfg.rope_theta)
            if k is not None:
                k = apply_rope(k, positions, cfg.rope_style, cfg.rope_theta)
        window = (cfg.sliding_window or None) if causal else None
        if cache is not None:
            paged = isinstance(cache, skvc.PagedSparseKVCache)
            if update_cache and paged:
                cache = skvc.paged_update(cache, k, v)
            elif update_cache and isinstance(cache, skvc.SparseKVCache):
                cache = skvc.update(cache, k, v)
            elif update_cache:
                cache = kvc.update(cache, k, v)
            qpos = (positions if causal
                    else torch.full_like(positions, NOT_CAUSAL))
            kpos = (skvc.paged_key_positions(cache) if paged
                    else kvc.key_positions(cache))
            if ((paged or isinstance(cache, skvc.SparseKVCache)) and causal
                    and cfg.sparse_mode != "dense" and q.shape[1] == 1):
                # bitmap-scheduled decode: both attention products go
                # through the grouped dispatch
                out = attend_sparse(q, cache, cfg, qpos=qpos, kpos=kpos,
                                    window=window)
            elif paged and cache.quantized:
                # dense-mode paged decode: the logical per-slot view under
                # the shared masked attend (per-row positions); an int8
                # pool's codes and scales go in raw, dequantised per chunk
                kp_, vp_, ksp, vsp = skvc.paged_view(cache, scales=True)
                out = attend(q, kp_, vp_, qpos=qpos, kpos=kpos,
                             window=window, chunk=chunk, k_scale=ksp,
                             v_scale=vsp)
            elif paged:
                kd, vd = skvc.paged_read(cache, dtype=x.dtype)
                out = attend(q, kd, vd, qpos=qpos, kpos=kpos, window=window,
                             chunk=chunk)
            elif cache.quantized:
                out = attend(q, cache.k, cache.v, qpos=qpos, kpos=kpos,
                             window=window, chunk=chunk,
                             k_scale=cache.k_scale, v_scale=cache.v_scale)
            else:
                kd, vd, _ = kvc.read(cache, dtype=x.dtype)
                out = attend(q, kd, vd, qpos=qpos, kpos=kpos, window=window,
                             chunk=chunk)
        elif causal:
            out = attend(q, k, v, qpos=positions, kpos=positions,
                         window=window, chunk=chunk)
        else:
            qpos = torch.full((x.shape[1],), NOT_CAUSAL, device=x.device)
            kpos = torch.arange(k.shape[1], device=x.device)
            out = attend(q, k, v, qpos=qpos, kpos=kpos, chunk=chunk)
        y = _proj(out, self.wo.to(x.dtype), cfg, "attn.out", n_contract=2,
                  plan_act=plans.get("wo"))
        return y, cache
