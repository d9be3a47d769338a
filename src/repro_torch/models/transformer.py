"""The transformer: decoder-only dense, MoE, Mamba2 (``ssm``) and
Mamba/attention hybrid stacks, the audio encoder-decoder and the VLM.

The JAX package stacks each period position's parameters over periods
and scans over them; here the layers are an ``nn.ModuleList`` walked by a
Python loop over ``n_layers``, with one cache entry per decoder layer.
Layer i is built as period position ``i % cfg.period``: its kind
(``cfg.layer_kind``: an attention, a Mamba or a cross block) and whether
its feed-forward block is a MoE (``cfg.layer_is_moe``).  The loop never
asks for ``n_periods``, so a depth that is not a multiple of the period
(a hybrid cut to its first two positions) runs too.
``Transformer.forward`` is the JAX package's ``forward`` and
``DecoderLayer.forward`` its ``_apply_layer``.  The forward sums the MoE
layers' auxiliary losses; :func:`lm_loss` is the training loss.  Every
parameter is built with ``requires_grad=False``, which serving keeps;
training turns them on (``model.requires_grad_(True)``), and a cacheless
forward under autograd then checkpoints each layer by ``rc.remat``.  A
tied model has no ``lm_head``: its head is ``embed.T``, which the sparse
modes plan per call.

The memory is built at prefill (and in a cacheless forward) only: the
conv frontend over ``batch["mel"]`` / ``batch["images"]``, or, without
``frontend_conv``, the stub's precomputed ``batch["frames"]`` /
``batch["image_embeds"]``.  The encoder-decoder (whisper) runs the
encoder stack (non-causal, no cache) over it; its decoder layers add
cross-attention over the encoder's memory.  The VLM's ``"cross"`` layers
have no self-attention: their attention reads the image memory,
non-causal and without RoPE, and adds ``tanh(gate_attn)`` times its
output.  Either way the prefill writes the memory's K/V into each
layer's cross cache, and decode reads them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

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


# the batch key of the memory's input, by (cfg.frontend, cfg.frontend_conv):
# raw mel frames / images into a conv frontend, or a stub's embeddings
MEMORY_INPUTS = {("audio", True): "mel", ("audio", False): "frames",
                 ("vision", True): "images",
                 ("vision", False): "image_embeds"}


class ModelOutputs(NamedTuple):
    logits: torch.Tensor
    caches: Optional[List[Any]]
    aux_loss: torch.Tensor      # float32 (), the MoE layers' sum; 0 without


def _check_family(cfg: ModelConfig) -> None:
    decoder_only = (cfg.family in ("dense", "moe", "ssm", "hybrid")
                    and not cfg.is_encoder_decoder and cfg.frontend == "none"
                    and not cfg.cross_attn_every)
    audio = (cfg.family == "audio" and cfg.is_encoder_decoder
             and cfg.frontend == "audio" and not cfg.cross_attn_every)
    vlm = (cfg.family == "vlm" and not cfg.is_encoder_decoder
           and cfg.frontend == "vision" and cfg.cross_attn_every > 0)
    if not (decoder_only or audio or vlm):
        raise ValueError(f"{cfg.name}: only the decoder-only dense, MoE, "
                         "Mamba2 and hybrid families, the audio "
                         "encoder-decoder and the VLM with its vision "
                         "frontend (each with its conv stem or its stub) "
                         "are ported")


class DecoderLayer(nn.Module):
    """One layer at period position ``pos``: norm1 + attn, [norm_cross +
    cross_attn,] norm2 + mlp (or moe, where ``cfg.layer_is_moe(pos)``);
    a ``"mamba"`` position holds norm1 + mamba in place of the attention,
    and a Mamba2 (``ssm``) stack no norm2 and no feed-forward block.  A
    VLM's ``"cross"`` position holds norm1 + attn (an ``Attention(cfg)``,
    qkv biases as a self-attention's, run over the image memory) and the
    scalar ``gate_attn``, zero at init, in place of the self-attention.
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
        if self.kind == "cross":
            self.gate_attn = nn.Parameter(torch.zeros((), **kw),
                                          requires_grad=False)
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
        """``cache``: a KVCache (decoder-only attention, or a VLM cross
        layer's image K/V), an SSMState (a Mamba layer), an EncDecCache (an
        encoder-decoder's decoder layer) or None; ``memory``: the encoder
        output or the image embeddings at prefill, None at decode (where a
        cross layer reads its filled cache); ``chunk``: attention's KV
        chunk.  A Mamba layer with a cache takes one token as a decode step
        (``mamba_step``) and more as a prefill that returns its state.
        Returns (x, the updated cache, the MoE's float32 auxiliary loss or
        None)."""
        plans = plans or {}
        h = apply_norm(self.norm1, x, cfg.norm_eps)
        if self.kind == "mamba":
            if cache is not None and x.shape[1] == 1:
                y, kv = ssmm.mamba_step(self.mamba, h, cfg, cache)
            else:
                y, kv = ssmm.mamba_forward(self.mamba, h, cfg, state=cache,
                                           return_state=cache is not None)
        elif self.kind == "cross":
            # cross-attention to the image memory, tanh-gated
            y, kv = self.attn(h, cfg, positions=positions, cache=cache,
                              plans=plans.get("attn"), kv_source=memory,
                              is_cross=True, update_cache=memory is not None,
                              chunk=chunk)
            y = torch.tanh(self.gate_attn).to(x.dtype) * y
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
    ``cfg.tie_embeddings``, lm_head (d, vocab); with ``cfg.frontend_conv``
    a conv ``frontend`` (audio or vision); an encoder-decoder adds
    ``enc_layers`` and ``enc_final_norm``."""

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
        if cfg.frontend_conv:
            self.frontend = fem.init_frontend(cfg, **kw)
        if cfg.is_encoder_decoder:
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
        if hasattr(self, "frontend"):
            self.frontend.reset_parameters(generator)
        if hasattr(self, "enc_layers"):
            for layer in self.enc_layers:
                layer.reset_parameters(generator)

    def memory(self, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               dtype, weight_plans: Optional[Dict] = None,
               chunk: int = 0, rc: Optional[RunConfig] = None
               ) -> Optional[torch.Tensor]:
        """The memory the cross layers read, or None when ``batch`` holds
        no modality input (a decode step, or a decoder-only model): the
        conv frontend over ``"mel"`` / ``"images"``, else the stub's
        ``"frames"`` / ``"image_embeds"`` cast to ``dtype``; an
        encoder-decoder's goes through :meth:`encode`."""
        key = MEMORY_INPUTS.get((cfg.frontend, cfg.frontend_conv))
        if key is None or key not in batch:
            return None
        wp = weight_plans or {}
        if cfg.frontend_conv:
            memory = fem.frontend_forward(self.frontend, batch, cfg, dtype,
                                          plans=wp.get("frontend"))
        else:
            memory = batch[key].to(dtype)
        if cfg.is_encoder_decoder:
            memory = self.encode(memory, cfg, weight_plans, chunk, rc)
        return memory

    def encode(self, memory: torch.Tensor, cfg: ModelConfig,
               weight_plans: Optional[Dict] = None, chunk: int = 0,
               rc: Optional[RunConfig] = None) -> torch.Tensor:
        """The encoder over the frontend's ``memory`` (B, M, d):
        sinusoidal positions, the non-causal encoder stack, its norm."""
        wp = weight_plans or {}
        m = memory.shape[1]
        pos = torch.arange(m, device=memory.device)
        x = memory + sinusoidal_positions(pos, cfg.d_model,
                                          memory.dtype)[None]
        plans = wp.get("enc_layers") or [None] * len(self.enc_layers)
        run = self._runner(rc, None)
        for layer, lp in zip(self.enc_layers, plans):
            x, _, _ = run(layer, x, cfg, positions=pos, plans=lp,
                          causal=False, chunk=chunk)
        return apply_norm(self.enc_final_norm, x, cfg.norm_eps)

    def _runner(self, rc: Optional[RunConfig], caches):
        """How each layer runs: called as it is, or, when a gradient is
        being taken of a cacheless forward (training), under one
        non-reentrant ``torch.utils.checkpoint`` per layer with
        ``rc.remat``'s policy (:func:`remat_context`; ``full`` without
        ``rc``, as in the JAX package)."""
        kind = rc.remat if rc else "full"
        if (kind == "none" or caches is not None
                or not torch.is_grad_enabled()
                or not any(p.requires_grad for p in self.parameters())):
            return lambda layer, *args, **kw: layer(*args, **kw)
        context = remat_context(kind)

        def run(layer, *args, **kw):
            # the recompute runs after the forward returns, when a caller's
            # functional_call no longer holds its tensors in the layer: so
            # the layer's tensors of now are the checkpoint's inputs
            return checkpoint(_call_with, layer,
                              dict(layer.named_parameters()), args, kw,
                              use_reentrant=False, context_fn=context)
        return run

    def forward(self, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                caches: Optional[List[Any]] = None,
                positions: Optional[torch.Tensor] = None,
                rc: Optional[RunConfig] = None,
                weight_plans: Optional[Dict] = None) -> ModelOutputs:
        """batch: {"tokens": (B, S)}, plus the memory's input at prefill:
        "mel" (B, T, n_mels) for an encoder-decoder, "images" (B, H, W, C)
        for a VLM with ``frontend_conv``, or the stubs' "frames" /
        "image_embeds" (B, M, d) without it; decode passes S == 1, the
        caches and the position of the new token (and no memory input: the
        memory's K/V are in the cross caches), or (B, 1) positions, one per
        row, over the serving engine's paged caches.  ``weight_plans`` are
        cached weight activities from :func:`plan_weight_activities`
        (optional: without them the sparse modes plan the weights per
        call).  ``aux_loss`` is the sum of the MoE layers' load-balancing
        losses.  Attention runs KV-chunked at ``rc.attn_chunk`` (2048
        without ``rc``).  A cacheless forward whose gradient is taken
        (grad mode on, parameters requiring grad) checkpoints each layer
        by ``rc.remat``."""
        tokens = batch["tokens"]
        s = tokens.shape[1]
        chunk = rc.attn_chunk if rc else 2048
        act_dtype = (torch.bfloat16 if rc is None
                     or rc.act_dtype == "bfloat16" else torch.float32)
        x = self.embed[tokens].to(act_dtype)
        if positions is None:
            positions = torch.arange(s, device=tokens.device)
        memory = self.memory(batch, cfg, act_dtype, weight_plans, chunk, rc)
        if (memory is None and caches is None
                and (cfg.is_encoder_decoder or cfg.cross_attn_every)):
            key = MEMORY_INPUTS[(cfg.frontend, cfg.frontend_conv)]
            raise ValueError(f"{cfg.name}: forward needs batch[{key!r}] "
                             "or filled cross caches")
        if cfg.abs_positions:
            # (B, S) positions (the multi-slot batched decode) per row
            pe = sinusoidal_positions(positions, cfg.d_model, x.dtype)
            x = x + (pe if positions.ndim == 2 else pe[None])
        layer_plans = (weight_plans["layers"] if weight_plans
                       else [None] * len(self.layers))
        new_caches = [] if caches is not None else None
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        run = self._runner(rc, caches)
        for i, layer in enumerate(self.layers):
            x, c, aux = run(layer, x, cfg, positions=positions,
                            cache=caches[i] if caches is not None else None,
                            plans=layer_plans[i], memory=memory, chunk=chunk)
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


def _call_with(layer: nn.Module, params: Dict[str, torch.Tensor], args,
               kw):
    return torch.func.functional_call(layer, params, args, kw)


# the products ``checkpoint_dots`` saves: the matmuls and batched einsums
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context(kind: str) -> Callable:
    """``torch.utils.checkpoint``'s ``context_fn`` for ``rc.remat``:
    ``full`` saves nothing of a layer (the JAX package's
    ``nothing_saveable``), ``dots`` saves the outputs of its matmuls and
    recomputes the rest (``checkpoint_dots``)."""
    if kind == "full":
        return noop_context_fn
    if kind == "dots":
        return lambda: create_selective_checkpoint_contexts(_save_dots)
    raise ValueError(f"remat must be full, dots or none, not {kind!r}")


def lm_loss(model: Transformer, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, rc: Optional[RunConfig] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (``batch["labels"]``, the tokens shifted
    by the caller; labels < 0 are masked): a float32 log-sum-exp over the
    logits, plus 0.01 x the MoE auxiliary loss.  Returns (total, {"loss",
    "aux_loss", "tokens"}): the JAX package's ``lm_loss``."""
    return loss_of(model(batch, cfg, rc=rc), batch["labels"])


def loss_of(out: ModelOutputs, labels: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`lm_loss` of a forward's outputs."""
    logits = out.logits.to(torch.float32)
    mask = (labels >= 0).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = (lse - ll) * mask
    loss = nll.sum() / mask.sum().clamp(min=1.0)
    total = loss + 0.01 * out.aux_loss
    return total, {"loss": loss, "aux_loss": out.aux_loss,
                   "tokens": mask.sum()}


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def active_params(cfg: ModelConfig, model: nn.Module) -> float:
    """Parameter count with the MoE experts' weights (not the routers)
    scaled to the active fraction ``n_experts_active / n_experts``."""
    total = count_params(model)
    if not cfg.n_experts:
        return float(total)
    e_params = sum(p.numel() for name, p in model.named_parameters()
                   if "moe" in name and any(w in name for w in (
                       "w_up", "w_down", "w_gate")))
    frac = cfg.n_experts_active / cfg.n_experts
    return float(total - e_params + e_params * frac)


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
    weights flattened to their 2-D dispatch shapes (a VLM cross layer's
    under ``"attn"``), a MoE's over its stacked (E, K, N) expert weights;
    an encoder-decoder adds ``"enc_layers"``, and a conv frontend its
    convs' ``"frontend"`` (the stem's or the patch's).  A Mamba block
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
    if cfg.frontend_conv:
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
    cache of ``encoder_len`` slots, and a VLM's cross layers a plain cache
    of ``num_image_tokens`` slots: in ``dtype``, never int8 and never
    sparse, whatever ``quantized`` and ``sparse`` say (as in the JAX
    package).
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

    def layer_cache(kind):
        if kind == "mamba":
            return ssmm.init_state(cfg, batch, dtype=dtype, device=dev)
        if kind == "cross":
            return kvc.init_cache(batch, cfg.num_image_tokens,
                                  cfg.n_kv_heads, cfg.hd, dtype=dtype,
                                  device=dev)
        return self_cache()

    if not cfg.is_encoder_decoder:
        return [layer_cache(cfg.layer_kind(i % cfg.period))
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
    slot: nothing to page).  Encoder-decoder and cross-attention stacks
    are not paged (their memory K/V are per request and fixed in size):
    they raise ``ValueError``, as in the JAX package."""
    if cfg.is_encoder_decoder or "cross" in [
            cfg.layer_kind(p) for p in range(cfg.period)]:
        raise ValueError(
            "paged serving supports decoder-only self-attention stacks")
    dev = devmod.resolve(device)
    return [ssmm.init_state(cfg, slots, dtype=dtype, device=dev)
            if cfg.layer_kind(i % cfg.period) == "mamba"
            else skvc.init_paged_cache(slots, pages, page_size, capacity,
                                       cfg.n_kv_heads, cfg.hd, dtype=dtype,
                                       quantized=quantized, device=dev)
            for i in range(cfg.n_layers)]
