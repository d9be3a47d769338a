"""The transformer: decoder-only dense, MoE, Mamba2 (``ssm``) and
Mamba/attention hybrid stacks, and the audio encoder-decoder.

The JAX package stacks each period position's parameters over periods
and scans over them; here the layers are an ``nn.ModuleList`` walked by a
Python loop over ``n_layers``, with one cache entry per decoder layer.
Layer i is built as period position ``i % cfg.period``: its kind
(``cfg.layer_kind``: an attention or a Mamba block) and whether its
feed-forward block is a MoE (``cfg.layer_is_moe``).  The loop never asks
for ``n_periods``, so a depth that is not a multiple of the period (a
hybrid cut to its first two positions) runs too.
``Transformer.forward`` is the JAX package's ``forward`` and
``DecoderLayer.forward`` its ``_apply_layer``.  The forward sums the MoE
layers' auxiliary losses.  A tied model has no ``lm_head``: its head is
``embed.T``, which the sparse modes plan per call.

The encoder-decoder (whisper) runs the conv frontend over ``batch["mel"]``
and the encoder stack (non-causal, no cache) at prefill only; its decoder
layers add cross-attention over the encoder's memory, whose K/V the
prefill writes into each layer's cross cache and decode reads.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import device as devmod
from repro_torch.models import cache as kvc
from repro_torch.models import frontend as fem
from repro_torch.models import ssm as ssmm
from repro_torch.models.attention import Attention
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.nn import apply_norm, init_norm, sinusoidal_positions
from repro_torch.sparse import kvcache as skvc
from repro_torch.sparse import plan as pln
from repro_torch.sparse import site
from repro_torch.sparse import weights as spw


class ModelOutputs(NamedTuple):
    logits: torch.Tensor
    caches: Optional[List[Any]]
    aux_loss: torch.Tensor      # float32 (), the MoE layers' sum; 0 without


def _check_family(cfg: ModelConfig) -> None:
    decoder_only = (cfg.family in ("dense", "moe", "ssm", "hybrid")
                    and not cfg.is_encoder_decoder and cfg.frontend == "none")
    audio = (cfg.family == "audio" and cfg.is_encoder_decoder
             and cfg.frontend == "audio" and cfg.frontend_conv)
    if not (decoder_only or audio):
        raise ValueError(f"{cfg.name}: only the decoder-only dense, MoE, "
                         "Mamba2 and hybrid families and the audio "
                         "encoder-decoder with its conv stem are ported "
                         "(not the VLM's cross layers and vision frontend)")


class DecoderLayer(nn.Module):
    """One layer at period position ``pos``: norm1 + attn, [norm_cross +
    cross_attn,] norm2 + mlp (or moe, where ``cfg.layer_is_moe(pos)``);
    a ``"mamba"`` position holds norm1 + mamba in place of the attention,
    and a Mamba2 (``ssm``) stack no norm2 and no feed-forward block.
    Encoder layers are the attention layer without ``cross``, run
    non-causal."""

    def __init__(self, cfg: ModelConfig, pos: int = 0, *,
                 cross: bool = False, device=None, dtype=None):
        super().__init__()
        d, kind = cfg.d_model, cfg.norm_kind
        kw = dict(device=device, dtype=dtype)
        self.kind = cfg.layer_kind(pos)
        self.norm1 = init_norm(d, kind, **kw)
        if self.kind == "mamba":
            self.mamba = ssmm.Mamba(cfg, **kw)
        else:
            self.attn = Attention(cfg, **kw)
        self.cross = cross
        if cross:
            self.norm_cross = init_norm(d, kind, **kw)
            self.cross_attn = Attention(cfg, cross=True, **kw)
        # "moe", "mlp" or None: the block's attribute, and its key in the
        # JAX parameter tree and in the weight plans
        self.ffn_key = None
        if self.kind != "mamba" or cfg.family != "ssm":
            self.norm2 = init_norm(d, kind, **kw)
            self.ffn_key = "moe" if cfg.layer_is_moe(pos) else "mlp"
            self.add_module(self.ffn_key, (
                MoE if self.ffn_key == "moe" else MLP)(cfg, **kw))

    @property
    def ffn(self):
        """The layer's feed-forward block: its MoE, its MLP or None."""
        return getattr(self, self.ffn_key) if self.ffn_key else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        (self.mamba if self.kind == "mamba" else self.attn
         ).reset_parameters(generator)
        if self.cross:
            self.cross_attn.reset_parameters(generator)
        if self.ffn is not None:
            self.ffn.reset_parameters(generator)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, cache=None,
                plans: Optional[Dict] = None,
                memory: Optional[torch.Tensor] = None,
                causal: bool = True, chunk: int = 0):
        """``cache``: a KVCache (decoder-only attention), an SSMState (a
        Mamba layer), an EncDecCache (a cross layer) or None; ``memory``:
        the encoder output at prefill, None at decode; ``chunk``:
        attention's KV chunk.  A Mamba layer with a cache takes one token
        as a decode step (``mamba_step``) and more as a prefill that
        returns its state.  Returns (x, the updated cache, the MoE's
        float32 auxiliary loss or None)."""
        plans = plans or {}
        h = apply_norm(self.norm1, x, cfg.norm_eps)
        if self.kind == "mamba":
            if cache is not None and x.shape[1] == 1:
                y, kv = ssmm.mamba_step(self.mamba, h, cfg, cache)
            else:
                y, kv = ssmm.mamba_forward(self.mamba, h, cfg, state=cache,
                                           return_state=cache is not None)
        else:
            kv, cross_kv = (cache if isinstance(cache, kvc.EncDecCache)
                            else (cache, None))
            y, kv = self.attn(h, cfg, positions=positions, cache=kv,
                              plans=plans.get("attn"), causal=causal,
                              chunk=chunk)
        x = x + y
        if self.cross:
            h = apply_norm(self.norm_cross, x, cfg.norm_eps)
            y, cross_kv = self.cross_attn(
                h, cfg, positions=positions, cache=cross_kv,
                plans=plans.get("cross_attn"), kv_source=memory,
                is_cross=True, update_cache=memory is not None, chunk=chunk)
            x = x + y
        aux = None
        if self.ffn is not None:
            h = apply_norm(self.norm2, x, cfg.norm_eps)
            y = self.ffn(h, cfg, plans=plans.get(self.ffn_key))
            y, aux = y if self.ffn_key == "moe" else (y, None)
            x = x + y
        if isinstance(cache, kvc.EncDecCache):
            return x, kvc.EncDecCache(kv=kv, cross_kv=cross_kv), aux
        return x, kv, aux


class Transformer(nn.Module):
    """embed (vocab, d), the decoder layers, final_norm and, unless
    ``cfg.tie_embeddings``, lm_head (d, vocab); an encoder-decoder adds
    ``frontend``, ``enc_layers`` and ``enc_final_norm``."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        _check_family(cfg)
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, **kw),
            requires_grad=False)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i % cfg.period, cross=cfg.is_encoder_decoder,
                         **kw)
            for i in range(cfg.n_layers))
        self.final_norm = init_norm(cfg.d_model, cfg.norm_kind, **kw)
        self.lm_head = (None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_size, **kw),
            requires_grad=False))
        if cfg.is_encoder_decoder:
            self.frontend = fem.AudioFrontend(cfg, **kw)
            self.enc_layers = nn.ModuleList(
                DecoderLayer(cfg, **kw) for _ in range(cfg.n_encoder_layers))
            self.enc_final_norm = init_norm(cfg.d_model, cfg.norm_kind, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded normal weights (the JAX package's stddevs), unit norms."""
        self.embed.normal_(0.0, 0.02, generator=generator)
        if self.lm_head is not None:
            self.lm_head.normal_(0.0, 0.02, generator=generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        if hasattr(self, "enc_layers"):
            self.frontend.reset_parameters(generator)
            for layer in self.enc_layers:
                layer.reset_parameters(generator)

    def encode(self, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               dtype, weight_plans: Optional[Dict] = None,
               chunk: int = 0) -> torch.Tensor:
        """The encoder memory: conv frontend over ``batch["mel"]``,
        sinusoidal positions, the non-causal encoder stack, its norm."""
        wp = weight_plans or {}
        memory = fem.frontend_forward(self.frontend, batch, cfg, dtype,
                                      plans=wp.get("frontend"))
        m = memory.shape[1]
        pos = torch.arange(m, device=memory.device)
        x = memory + sinusoidal_positions(pos, cfg.d_model,
                                          memory.dtype)[None]
        plans = wp.get("enc_layers") or [None] * len(self.enc_layers)
        for layer, lp in zip(self.enc_layers, plans):
            x, _, _ = layer(x, cfg, positions=pos, plans=lp, causal=False,
                            chunk=chunk)
        return apply_norm(self.enc_final_norm, x, cfg.norm_eps)

    def forward(self, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                caches: Optional[List[Any]] = None,
                positions: Optional[torch.Tensor] = None,
                rc: Optional[RunConfig] = None,
                weight_plans: Optional[Dict] = None) -> ModelOutputs:
        """batch: {"tokens": (B, S)}, plus "mel" (B, T, n_mels) for an
        encoder-decoder at prefill; decode passes S == 1, the caches and
        the position of the new token (and no mel: the memory's K/V are
        in the cross caches), or (B, 1) positions, one per row, over the
        serving engine's paged caches.  ``weight_plans`` are cached weight
        activities from :func:`plan_weight_activities` (optional: without
        them the sparse modes plan the weights per call).  ``aux_loss`` is
        the sum of the MoE layers' load-balancing losses.  Attention runs
        KV-chunked at ``rc.attn_chunk`` (2048 without ``rc``)."""
        tokens = batch["tokens"]
        s = tokens.shape[1]
        chunk = rc.attn_chunk if rc else 2048
        act_dtype = (torch.bfloat16 if rc is None
                     or rc.act_dtype == "bfloat16" else torch.float32)
        x = self.embed[tokens].to(act_dtype)
        if positions is None:
            positions = torch.arange(s, device=tokens.device)
        memory = None
        if cfg.is_encoder_decoder:
            if "mel" in batch:
                memory = self.encode(batch, cfg, act_dtype, weight_plans,
                                     chunk)
            elif caches is None:
                raise ValueError(f"{cfg.name}: forward needs batch['mel'] "
                                 "or filled cross caches")
        if cfg.abs_positions:
            # (B, S) positions (the multi-slot batched decode) per row
            pe = sinusoidal_positions(positions, cfg.d_model, x.dtype)
            x = x + (pe if positions.ndim == 2 else pe[None])
        layer_plans = (weight_plans["layers"] if weight_plans
                       else [None] * len(self.layers))
        new_caches = [] if caches is not None else None
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self.layers):
            x, c, aux = layer(x, cfg, positions=positions,
                              cache=caches[i] if caches is not None else None,
                              plans=layer_plans[i], memory=memory,
                              chunk=chunk)
            if aux is not None:
                aux_total = aux_total + aux
            if new_caches is not None:
                new_caches.append(c)
        x = apply_norm(self.final_norm, x, cfg.norm_eps)
        head = self.lm_head
        if cfg.sparse_mode == "dense":
            logits = x @ (self.embed.t() if head is None else head
                          ).to(x.dtype)
        else:
            if head is None:
                # a tied head: embed.T, copied contiguous for the kernel
                # (which reads its operands dense, row-major) and planned
                # per call, as the JAX package plans it
                head = self.embed.to(x.dtype).t().contiguous()
            head_site = site.make("matmul", "lm_head", axes=("embed", "vocab"))
            logits, _ = site.matmul(
                x, spw.planned_or_array(head, weight_plans, "lm_head",
                                        x.dtype, cfg.sparse_slice_k,
                                        site=head_site),
                head_site, cfg)
        return ModelOutputs(logits=logits, caches=new_caches,
                            aux_loss=aux_total)


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               *, device=None, dtype=torch.bfloat16) -> Transformer:
    """Build the model on ``device`` (None: the card) with weights drawn
    from ``generator`` (default: a generator on that device seeded 0).
    Weights are made in ``dtype`` directly, with no float32 copy."""
    dev = devmod.resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = Transformer(cfg, device=dev, dtype=dtype)
    model.reset_parameters(generator)
    return model


def plan_weight_activities(model: Transformer, cfg: ModelConfig
                           ) -> Optional[Dict]:
    """Weight-side slice activities for every dispatch-routed projection
    (built once at load; None in dense mode): ``{"layers": [{"attn":
    {wq, wk, wv, wo}, ["cross_attn": {...},] "mlp" or "moe": {w_up,
    w_down[, w_gate][, @elem]}}, ...], "lm_head": ...}``, the attention
    weights flattened to their 2-D dispatch shapes, a MoE's over its
    stacked (E, K, N) expert weights; an encoder-decoder adds
    ``"enc_layers"`` and the stem convs' ``"frontend"``.  A Mamba block
    plans nothing (its projections are plain matmuls, as in the JAX
    package), and a tied head has no ``"lm_head"`` entry: it is planned
    per call.
    """
    if cfg.sparse_mode == "dense":
        return None
    sk = cfg.sparse_slice_k

    def plan_of(w: torch.Tensor) -> torch.Tensor:
        return pln.slice_activity_rhs(
            w, pln.effective_slice_k(w.shape[-2], sk))

    def attn_plans(a: Attention) -> Dict[str, torch.Tensor]:
        return {"wq": plan_of(a.wq.reshape(a.wq.shape[0], -1)),
                "wk": plan_of(a.wk.reshape(a.wk.shape[0], -1)),
                "wv": plan_of(a.wv.reshape(a.wv.shape[0], -1)),
                "wo": plan_of(a.wo.reshape(-1, a.wo.shape[-1]))}

    def layer_plans(layer: DecoderLayer) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if layer.kind != "mamba":
            out["attn"] = attn_plans(layer.attn)
        if layer.ffn is not None:
            out[layer.ffn_key] = spw.plan_layer_weights(
                layer.ffn.weights(), slice_k=sk,
                block_n=cfg.sparse_block_n if cfg.sparse_kcondense else None)
        if layer.cross:
            out["cross_attn"] = attn_plans(layer.cross_attn)
        return out

    plans: Dict[str, Any] = {
        "layers": [layer_plans(layer) for layer in model.layers]}
    if model.lm_head is not None:
        plans["lm_head"] = plan_of(model.lm_head)
    if cfg.is_encoder_decoder:
        plans["enc_layers"] = [layer_plans(layer)
                               for layer in model.enc_layers]
        plans["frontend"] = fem.plan_frontend_activities(model.frontend, cfg)
    return plans


def init_caches(cfg: ModelConfig, batch: int, capacity: int, *,
                quantized: bool = False, dtype=torch.bfloat16,
                sparse: Optional[bool] = None, full_history: bool = False,
                device=None) -> List[Any]:
    """One cache per decoder layer, bf16 whatever the activation dtype, as
    in the JAX package, or int8 with scales when ``quantized``.

    ``sparse`` (default: ``cfg.sparse_kv`` in a non-dense sparse mode)
    allocates :class:`~repro_torch.sparse.kvcache.SparseKVCache` s of the
    full ``capacity`` with no ring (``window=capacity``): a sliding window
    is applied as the attention mask instead, and the blocks it hides are
    what the decode schedule skips.  Plain caches of a sliding-window
    model keep ``window`` ring slots, unless ``full_history``: then every
    cache holds all ``capacity`` slots with no wrap (token i in slot i),
    the layout the serving engine's prefill caches need so that
    ``insert_prefill`` can lift contiguous rows into pool pages.  An
    encoder-decoder's layers hold
    :class:`~repro_torch.models.cache.EncDecCache` s, each with a cross
    cache of ``encoder_len`` slots (bf16 always, as in the JAX package).
    A Mamba layer holds a zero :class:`~repro_torch.models.ssm.SSMState`
    (float32 state, the conv tail in ``dtype``) whatever the capacity.
    """
    dev = devmod.resolve(device)
    if sparse is None:
        sparse = cfg.sparse_kv and cfg.sparse_mode != "dense"

    def self_cache():
        if sparse:
            return skvc.init_sparse_cache(
                batch, capacity, cfg.n_kv_heads, cfg.hd, dtype=dtype,
                quantized=quantized, window=capacity,
                block_t=cfg.sparse_block_t, device=dev)
        ring = (capacity if full_history
                else min(cfg.sliding_window or capacity, capacity))
        return kvc.init_cache(batch, ring, cfg.n_kv_heads, cfg.hd,
                              dtype=dtype, quantized=quantized, window=ring,
                              device=dev)

    if not cfg.is_encoder_decoder:
        return [ssmm.init_state(cfg, batch, dtype=dtype, device=dev)
                if cfg.layer_kind(i % cfg.period) == "mamba" else self_cache()
                for i in range(cfg.n_layers)]
    return [kvc.EncDecCache(
                kv=self_cache(),
                cross_kv=kvc.init_cache(batch, cfg.encoder_len,
                                        cfg.n_kv_heads, cfg.hd, dtype=dtype,
                                        device=dev))
            for _ in range(cfg.n_layers)]


def init_paged_caches(cfg: ModelConfig, slots: int, pages: int,
                      page_size: int, capacity: int, *,
                      quantized: bool = False, dtype=torch.bfloat16,
                      device=None) -> List[Any]:
    """The continuous-batching engine's decode caches: one
    :class:`~repro_torch.sparse.kvcache.PagedSparseKVCache` per attention
    layer, each its own page pool of ``pages`` pages (int8 with scales
    when ``quantized``) with per-slot block tables, and a zero per-slot
    :class:`~repro_torch.models.ssm.SSMState` per Mamba layer (O(1) a
    slot: nothing to page).  Encoder-decoder stacks are not paged (their
    memory K/V are per request and fixed in size): they raise
    ``ValueError``, as in the JAX package."""
    if cfg.is_encoder_decoder:
        raise ValueError(
            "paged serving supports decoder-only self-attention stacks")
    dev = devmod.resolve(device)
    return [ssmm.init_state(cfg, slots, dtype=dtype, device=dev)
            if cfg.layer_kind(i % cfg.period) == "mamba"
            else skvc.init_paged_cache(slots, pages, page_size, capacity,
                                       cfg.n_kv_heads, cfg.hd, dtype=dtype,
                                       quantized=quantized, device=dev)
            for i in range(cfg.n_layers)]
