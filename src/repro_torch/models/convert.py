"""Load the JAX package's parameters into the port: ``init_model``
trees (:func:`from_jax_params`) and ``init_sparse_linear`` dicts
(:func:`sparse_linear_from_jax`).

The JAX pytree is layer-stacked: ``params["layers"]["pos0"][...]`` (and
an encoder-decoder's ``params["enc_layers"]["pos0"][...]``) has a leading
layer axis (the period is 1 for the ported families), which is unstacked
here into the port's per-layer modules: a MoE layer's ``moe`` leaves
(router, stacked expert weights) as its ``mlp`` leaves are, and a
self-attention's qkv biases ``bq``/``bk``/``bv`` beside its weights.  Layouts are the
same on both sides, so each leaf is a plain copy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import device as devmod
from repro_torch.models.transformer import Transformer


def from_jax_params(tree, cfg: ModelConfig, device=None,
                    dtype=torch.float32) -> Transformer:
    """A :class:`Transformer` on ``device`` (None: the card) holding the
    numpy leaves of a JAX ``init_model`` tree, cast to ``dtype``."""
    dev = devmod.resolve(device)
    model = Transformer(cfg, device=dev, dtype=dtype)

    def put(param: torch.Tensor, leaf) -> None:
        arr = np.asarray(leaf, dtype=np.float32)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"shape {arr.shape} != {tuple(param.shape)}")
        param.copy_(torch.from_numpy(arr.copy()))

    def put_layers(layers, stack) -> None:
        for i, layer in enumerate(layers):
            norms = ("norm1", "norm2") + (("norm_cross",) if layer.cross
                                          else ())
            for norm in norms:
                for key, p in getattr(layer, norm).items():
                    put(p, stack[norm][key][i])
            for blk in ("attn", "cross_attn") if layer.cross else ("attn",):
                attn = getattr(layer, blk)
                keys = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv")
                                                   if attn.bias else ())
                for key in keys:
                    put(getattr(attn, key), stack[blk][key][i])
            ffn = layer.ffn_key
            keys = tuple(layer.ffn.weights()) + (("router",) if ffn == "moe"
                                                 else ())
            for key in keys:
                put(getattr(layer.ffn, key), stack[ffn][key][i])

    with torch.no_grad():
        put(model.embed, tree["embed"])
        put(model.final_norm["scale"], tree["final_norm"]["scale"])
        if "bias" in model.final_norm:
            put(model.final_norm["bias"], tree["final_norm"]["bias"])
        put(model.lm_head, tree["lm_head"])
        put_layers(model.layers, tree["layers"]["pos0"])
        if cfg.is_encoder_decoder:
            put_layers(model.enc_layers, tree["enc_layers"]["pos0"])
            for key, p in model.enc_final_norm.items():
                put(p, tree["enc_final_norm"][key])
            for key in ("conv1", "b1", "conv2", "b2"):
                put(getattr(model.frontend, key), tree["frontend"][key])
    return model


def sparse_linear_from_jax(params, device=None,
                           dtype=torch.float32) -> dict:
    """The port's ``DualSparseLinear`` params from a JAX
    ``init_sparse_linear`` dict of numpy-convertible leaves (``w``,
    ``mask``, optional ``b``): ``w``/``b`` cast to ``dtype``, ``mask``
    bool, all on ``device`` (None: the card)."""
    dev = devmod.resolve(device)
    out = {"w": torch.from_numpy(np.asarray(params["w"], np.float32).copy()
                                 ).to(dev, dtype),
           "mask": torch.from_numpy(np.asarray(params["mask"], bool).copy()
                                    ).to(dev)}
    if "b" in params:
        out["b"] = torch.from_numpy(np.asarray(params["b"], np.float32).copy()
                                    ).to(dev, dtype)
    return out
