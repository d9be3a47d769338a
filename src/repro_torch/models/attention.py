"""Attention: GQA with RoPE over a plain or sparse KV cache, and the
encoder-decoder's non-causal self-attention and cross-attention.

Grouped-query attention never materialises repeated KV heads (an explicit
group dim), and the softmax runs in float32.  ``Attention.forward`` is the
JAX package's ``attention_forward`` (no qkv bias, no int8 cache); its
KV-chunked long-context path (``chunk``) is not ported — this
:func:`attend` is the single-block path, the same function up to rounding.
Decode over a :class:`~repro_torch.sparse.kvcache.SparseKVCache` in a
sparse mode runs :func:`attend_sparse`.
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
    ang = positions.to(torch.float32)[..., None] * freqs   # (S, dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, style: str,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) absolute token positions."""
    if style == "none":
        return x
    hd = x.shape[-1]
    rot = hd if style == "half" else hd // 2   # chatglm "2d": half the dims
    cos, sin = _rope_angles(positions, rot, theta)
    cos = cos[None, :, None, :].to(x.dtype)
    sin = sin[None, :, None, :].to(x.dtype)
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
    absolute positions (-1 = invalid slot).  Returns (acc (B,Sq,KV,G,hd)
    f32, row max m, row sumexp l), the last two (B, Sq, KV, G).
    """
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                          k.to(torch.float32))
    scores = scores * (q.shape[-1] ** -0.5)
    kp = kpos[None, :]
    qp = qpos[:, None]
    valid = (kp >= 0) & (kp <= qp)
    if window is not None:
        valid &= kp > (qp - window)
    vb = valid[None, None, None]                 # (1, 1, 1, Sq, Skv)
    scores = torch.where(vb, scores, NEG_INF)
    m = scores.amax(-1)                          # (B, KV, G, Sq)
    e = torch.exp(scores - m[..., None])
    e = torch.where(vb, e, 0.0)
    l = e.sum(-1)
    acc = torch.einsum("bkgqs,bskd->bqkgd", e, v.to(torch.float32))
    return acc, m.movedim(3, 1), l.movedim(3, 1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           qpos: torch.Tensor, kpos: torch.Tensor,
           window: Optional[int] = None) -> torch.Tensor:
    """Masked GQA attention.  q: (B,Sq,H,hd), k/v: (B,Skv,KVH,hd)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    acc, _, l = _attend_block(qg, k, v, qpos, kpos, window)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attend_sparse(q: torch.Tensor, cache: skvc.SparseKVCache,
                  cfg: ModelConfig, *, qpos: torch.Tensor,
                  kpos: torch.Tensor,
                  window: Optional[int] = None) -> torch.Tensor:
    """Bitmap-scheduled decode attention over a ``SparseKVCache``.

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
    """
    b, _, h, hd = q.shape
    t = cache.capacity
    kvh = cache.k.shape[-2]
    g = h // kvh
    ne = b * kvh

    kd, vd, _ = kvc.read(cache, dtype=q.dtype)
    occ = skvc.occupancy_mask(cache)
    k_e = kd.transpose(1, 2).reshape(ne, t, hd)
    v_e = vd.transpose(1, 2).reshape(ne, t, hd)
    q_e = q.reshape(b, kvh, g, hd).transpose(2, 3).reshape(ne, hd, g)

    # occupancy equals kpos >= 0, so the schedule is also the softmax mask
    sched = pln.kv_decode_slots(occ, kpos, qpos[0], window)
    # attn.score tiles slot rows at block_m, attn.value slices the slot
    # contraction at slice_k; both resolve before the operands are built,
    # which must carry metadata at the served tiles
    st_s = site.make("attn.score", "attn.score", out_dtype="float32")
    st_v = site.make("attn.value", "attn.value", out_dtype="float32")
    kw_s = site.resolve(st_s, cfg)
    kw_v = site.resolve(st_v, cfg)
    bt = pln.effective_slice_k(t, kw_v["slice_k"])
    sk_hd = pln.effective_slice_k(hd, kw_s["slice_k"])

    x_k = skvc.score_operand(k_e, sched, sk_hd)
    scores_t, _ = site.grouped_matmul(x_k, q_e, st_s, cfg, resolved=kw_s)
    scores = scores_t.reshape(b, kvh, t, g).transpose(2, 3)
    scores = scores[:, :, :, None, :] * (hd ** -0.5)     # (B,KV,G,1,T)

    valid = sched[None, None, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(-1)
    e = torch.exp(scores - m[..., None])
    e = torch.where(valid, e, 0.0)
    l = e.sum(-1)                                        # (B,KV,G,1)

    p_e = e[:, :, :, 0, :].reshape(ne, g, t)
    x_p, w_v = skvc.value_operands(occ, p_e, v_e, sched, bt)
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
    hd), wo (h, hd, d)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        hd, h, kv, d = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype), requires_grad=False)
        self.wq = param(d, h, hd)
        self.wk = param(d, kv, hd)
        self.wv = param(d, kv, hd)
        self.wo = param(h, hd, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.wq.shape[0] ** -0.5
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.normal_(0.0, std, generator=generator)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor,
                cache: Optional[kvc.KVCache] = None,
                plans: Optional[Dict] = None,
                kv_source: Optional[torch.Tensor] = None,
                is_cross: bool = False,
                causal: bool = True,
                update_cache: bool = True
                ) -> Tuple[torch.Tensor, Optional[kvc.KVCache]]:
        """Projections + attend (+ cache write) + output: the JAX
        package's ``attention_forward``.

        Self-attention takes K/V from x, with RoPE (``causal=False`` is
        the encoder's: every query sees every key).  Cross-attention
        (``is_cross``, never causal, no RoPE) takes K/V from the memory
        ``kv_source``, written to the cross cache when ``update_cache``
        (prefill); at decode (``kv_source=None``, ``update_cache=False``)
        it projects no K/V and reads the cache.  x: (B, S, D); positions:
        (S,) absolute positions of x.  Returns (y (B, S, D), the updated
        cache or None).
        """
        if is_cross:
            causal = False
            if kv_source is None and cache is None:
                raise ValueError("cross-attention needs the memory or a "
                                 "filled cross cache")
        plans = plans or {}
        q = _proj(x, self.wq.to(x.dtype), cfg, "attn.q",
                  plan_act=plans.get("wq"))
        k = v = None
        if kv_source is not None or cache is None or update_cache:
            src = x if kv_source is None else kv_source
            k = _proj(src, self.wk.to(x.dtype), cfg, "attn.k",
                      plan_act=plans.get("wk"))
            v = _proj(src, self.wv.to(x.dtype), cfg, "attn.v",
                      plan_act=plans.get("wv"))
        if not is_cross:
            q = apply_rope(q, positions, cfg.rope_style, cfg.rope_theta)
            if k is not None:
                k = apply_rope(k, positions, cfg.rope_style, cfg.rope_theta)
        window = (cfg.sliding_window or None) if causal else None
        if cache is not None:
            if update_cache and isinstance(cache, skvc.SparseKVCache):
                cache = skvc.update(cache, k, v)
            elif update_cache:
                cache = kvc.update(cache, k, v)
            qpos = (positions if causal
                    else torch.full_like(positions, NOT_CAUSAL))
            kpos = kvc.key_positions(cache)
            if (isinstance(cache, skvc.SparseKVCache) and causal
                    and cfg.sparse_mode != "dense" and q.shape[1] == 1):
                # bitmap-scheduled decode: both attention products go
                # through the grouped dispatch
                out = attend_sparse(q, cache, cfg, qpos=qpos, kpos=kpos,
                                    window=window)
            else:
                kd, vd, _ = kvc.read(cache, dtype=x.dtype)
                out = attend(q, kd, vd, qpos=qpos, kpos=kpos, window=window)
        elif causal:
            out = attend(q, k, v, qpos=positions, kpos=positions,
                         window=window)
        else:
            qpos = torch.full((x.shape[1],), NOT_CAUSAL, device=x.device)
            kpos = torch.arange(k.shape[1], device=x.device)
            out = attend(q, k, v, qpos=qpos, kpos=kpos)
        y = _proj(out, self.wo.to(x.dtype), cfg, "attn.out", n_contract=2,
                  plan_act=plans.get("wo"))
        return y, cache
