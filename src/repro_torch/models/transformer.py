"""The decoder-only dense transformer.

The JAX package stacks each period position's parameters over periods
and scans over them; here the layers are an ``nn.ModuleList`` walked by a
Python loop, with one KV cache per layer.  ``Transformer.forward`` is the
JAX package's ``forward`` and ``DecoderLayer.forward`` its
``_apply_layer``.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import device as devmod
from repro_torch.models import cache as kvc
from repro_torch.models.attention import Attention
from repro_torch.models.mlp import MLP
from repro_torch.models.nn import apply_norm, init_norm
from repro_torch.sparse import kvcache as skvc
from repro_torch.sparse import plan as pln
from repro_torch.sparse import site
from repro_torch.sparse import weights as spw


class ModelOutputs(NamedTuple):
    logits: torch.Tensor
    caches: Optional[List[kvc.KVCache]]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.period != 1:
        raise ValueError(f"{cfg.name}: only the decoder-only dense family "
                         "is ported")


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.norm1 = init_norm(cfg.d_model, cfg.norm_kind, device=device,
                               dtype=dtype)
        self.attn = Attention(cfg, device=device, dtype=dtype)
        self.norm2 = init_norm(cfg.d_model, cfg.norm_kind, device=device,
                               dtype=dtype)
        self.mlp = MLP(cfg, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor,
                cache: Optional[kvc.KVCache] = None,
                plans: Optional[Dict] = None):
        plans = plans or {}
        h = apply_norm(self.norm1, x, cfg.norm_eps)
        y, cache = self.attn(h, cfg, positions=positions, cache=cache,
                             plans=plans.get("attn"))
        x = x + y
        h = apply_norm(self.norm2, x, cfg.norm_eps)
        return x + self.mlp(h, cfg, plans=plans.get("mlp")), cache


class Transformer(nn.Module):
    """embed (vocab, d), the layers, final_norm, lm_head (d, vocab)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        _check_family(cfg)
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, device=device,
                        dtype=dtype), requires_grad=False)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device=device, dtype=dtype)
            for _ in range(cfg.n_layers))
        self.final_norm = init_norm(cfg.d_model, cfg.norm_kind,
                                    device=device, dtype=dtype)
        self.lm_head = nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_size, device=device,
                        dtype=dtype), requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded normal weights (the JAX package's stddevs), unit norms."""
        self.embed.normal_(0.0, 0.02, generator=generator)
        self.lm_head.normal_(0.0, 0.02, generator=generator)
        for layer in self.layers:
            layer.attn.reset_parameters(generator)
            layer.mlp.reset_parameters(generator)

    def forward(self, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                caches: Optional[List[kvc.KVCache]] = None,
                positions: Optional[torch.Tensor] = None,
                rc: Optional[RunConfig] = None,
                weight_plans: Optional[Dict] = None) -> ModelOutputs:
        """batch: {"tokens": (B, S)}; decode passes S == 1, the caches and
        the position of the new token.  ``weight_plans`` are cached weight
        activities from :func:`plan_weight_activities` (optional: without
        them the sparse modes plan the weights per call)."""
        tokens = batch["tokens"]
        s = tokens.shape[1]
        act_dtype = (torch.bfloat16 if rc is None
                     or rc.act_dtype == "bfloat16" else torch.float32)
        x = self.embed[tokens].to(act_dtype)
        if positions is None:
            positions = torch.arange(s, device=tokens.device)
        layer_plans = (weight_plans["layers"] if weight_plans
                       else [None] * len(self.layers))
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            x, c = layer(x, cfg, positions=positions,
                         cache=caches[i] if caches is not None else None,
                         plans=layer_plans[i])
            if new_caches is not None:
                new_caches.append(c)
        x = apply_norm(self.final_norm, x, cfg.norm_eps)
        if cfg.sparse_mode == "dense":
            logits = x @ self.lm_head.to(x.dtype)
        else:
            head_site = site.make("matmul", "lm_head", axes=("embed", "vocab"))
            logits, _ = site.matmul(
                x, spw.planned_or_array(self.lm_head, weight_plans, "lm_head",
                                        x.dtype, cfg.sparse_slice_k,
                                        site=head_site),
                head_site, cfg)
        return ModelOutputs(logits=logits, caches=new_caches)


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
    {wq, wk, wv, wo}, "mlp": {w_up, w_down[, @elem]}}, ...], "lm_head":
    ...}``, the attention weights flattened to their 2-D dispatch shapes.
    """
    if cfg.sparse_mode == "dense":
        return None
    sk = cfg.sparse_slice_k

    def plan_of(w: torch.Tensor) -> torch.Tensor:
        return pln.slice_activity_rhs(
            w, pln.effective_slice_k(w.shape[-2], sk))

    layers: List[Dict[str, Any]] = []
    for layer in model.layers:
        a = layer.attn
        layers.append({
            "attn": {
                "wq": plan_of(a.wq.reshape(a.wq.shape[0], -1)),
                "wk": plan_of(a.wk.reshape(a.wk.shape[0], -1)),
                "wv": plan_of(a.wv.reshape(a.wv.shape[0], -1)),
                "wo": plan_of(a.wo.reshape(-1, a.wo.shape[-1])),
            },
            "mlp": spw.plan_layer_weights(
                {"w_up": layer.mlp.w_up, "w_down": layer.mlp.w_down},
                slice_k=sk,
                block_n=cfg.sparse_block_n if cfg.sparse_kcondense else None),
        })
    return {"layers": layers, "lm_head": plan_of(model.lm_head)}


def init_caches(cfg: ModelConfig, batch: int, capacity: int, *,
                dtype=torch.bfloat16, device=None) -> List[kvc.KVCache]:
    """One KV cache per layer, bf16 whatever the activation dtype, as in
    the JAX package.

    ``cfg.sparse_kv`` in a non-dense sparse mode allocates
    :class:`~repro_torch.sparse.kvcache.SparseKVCache` s of the full
    ``capacity`` with no ring (``window=capacity``): a sliding window is
    applied as the attention mask instead, and the blocks it hides are
    what the decode schedule skips.  Plain caches of a sliding-window
    model keep ``window`` ring slots.
    """
    dev = devmod.resolve(device)
    if cfg.sparse_kv and cfg.sparse_mode != "dense":
        return [skvc.init_sparse_cache(batch, capacity, cfg.n_kv_heads,
                                       cfg.hd, dtype=dtype, window=capacity,
                                       block_t=cfg.sparse_block_t, device=dev)
                for _ in range(cfg.n_layers)]
    ring = min(cfg.sliding_window or capacity, capacity)
    return [kvc.init_cache(batch, ring, cfg.n_kv_heads, cfg.hd, dtype=dtype,
                           window=ring, device=dev)
            for _ in range(cfg.n_layers)]
