"""Load the JAX package's parameters into the port: ``init_model``
trees (:func:`from_jax_params`) and ``init_sparse_linear`` dicts
(:func:`sparse_linear_from_jax`).

The JAX pytree is layer-stacked by period position:
``params["layers"][f"pos{p}"][...]`` has a leading axis over the periods,
so the port's layer i is ``[f"pos{i % P}"][...][i // P]`` with P the
period (an encoder-decoder's ``params["enc_layers"]["pos0"]`` has period
1).  Each layer's leaves go to its modules: a MoE layer's ``moe`` leaves
(router, stacked expert weights) as its ``mlp`` leaves are, a Mamba
block's ``mamba`` leaves, and a self-attention's qkv biases
``bq``/``bk``/``bv`` beside its weights.  A tied model has no
``lm_head``.  Layouts are the same on both sides, so each leaf is a plain
copy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import device as devmod
from repro_torch.models.transformer import Transformer

MAMBA_KEYS = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D", "norm",
              "out_proj")


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

    def put_layers(layers, stacks, period: int) -> None:
        for i, layer in enumerate(layers):
            stack, j = stacks[f"pos{i % period}"], i // period
            norms = (("norm1",) + (("norm2",) if layer.ffn is not None
                                   else ())
                     + (("norm_cross",) if layer.cross else ()))
            for norm in norms:
                for key, p in getattr(layer, norm).items():
                    put(p, stack[norm][key][j])
            if layer.kind == "mamba":
                for key in MAMBA_KEYS:
                    put(getattr(layer.mamba, key), stack["mamba"][key][j])
            blks = (() if layer.kind == "mamba" else ("attn",)) + (
                ("cross_attn",) if layer.cross else ())
            for blk in blks:
                attn = getattr(layer, blk)
                keys = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv")
                                                   if attn.bias else ())
                for key in keys:
                    put(getattr(attn, key), stack[blk][key][j])
            ffn = layer.ffn_key
            if ffn is None:
                continue
            keys = tuple(layer.ffn.weights()) + (("router",) if ffn == "moe"
                                                 else ())
            for key in keys:
                put(getattr(layer.ffn, key), stack[ffn][key][j])

    with torch.no_grad():
        put(model.embed, tree["embed"])
        put(model.final_norm["scale"], tree["final_norm"]["scale"])
        if "bias" in model.final_norm:
            put(model.final_norm["bias"], tree["final_norm"]["bias"])
        if model.lm_head is not None:
            put(model.lm_head, tree["lm_head"])
        put_layers(model.layers, tree["layers"], cfg.period)
        if cfg.is_encoder_decoder:
            put_layers(model.enc_layers, tree["enc_layers"], 1)
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
