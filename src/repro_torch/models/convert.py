"""Load the JAX package's parameters into the port: ``init_model``
trees (:func:`from_jax_params`), ``init_sparse_linear`` dicts
(:func:`sparse_linear_from_jax`) and optimizer states
(:func:`opt_state_from_jax`).

The JAX pytree is layer-stacked by period position:
``params["layers"][f"pos{p}"][...]`` has a leading axis over the periods,
so the port's layer i is ``[f"pos{i % P}"][...][i // P]`` with P the
period (5 for the VLM; an encoder-decoder's
``params["enc_layers"]["pos0"]`` has period 1).  Each layer's leaves go
to its modules: a MoE layer's ``moe`` leaves (router, stacked expert
weights) as its ``mlp`` leaves are, a Mamba block's ``mamba`` leaves, an
attention's qkv biases ``bq``/``bk``/``bv`` beside its weights, and a
VLM cross layer's scalar ``gate_attn``.  A conv frontend's leaves
(``conv1``/``b1``/``conv2``/``b2``, or ``patch``/``bias``/``pos`` and
``cls``) go to ``model.frontend``.  A tied model has no ``lm_head``.
Layouts are the same on both sides, so each leaf is a plain copy.

The name map: :func:`repro_torch.training.optimizer.stacked_leaf` gives
the JAX leaf (and stacking index) of a port parameter, and
:func:`param_axes` its logical axes, the JAX
package's ``init_model`` specs without the stacking axis ``"layers"``
(``layers.posP.attn.wq`` has ``("layers", "embed", "heads",
"head_dim")``; the port's ``layers.i.attn.wq`` has ``("embed", "heads",
"head_dim")``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import device as devmod
from repro_torch.models.transformer import Transformer
from repro_torch.training import optimizer as opt

MAMBA_KEYS = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D", "norm",
              "out_proj")

_ATTN_AXES = {"wq": ("embed", "heads", "head_dim"),
              "wk": ("embed", "kv_heads", "head_dim"),
              "wv": ("embed", "kv_heads", "head_dim"),
              "wo": ("heads", "head_dim", "embed"),
              "bq": ("heads", "head_dim"),
              "bk": ("kv_heads", "head_dim"),
              "bv": ("kv_heads", "head_dim")}
# the JAX package's logical axes of each leaf, by the block that holds it
# (a layer's, without "layers"); a norm block's leaves are ("embed",)
_BLOCK_AXES = {
    "attn": _ATTN_AXES,
    "cross_attn": _ATTN_AXES,
    "mlp": {"w_up": ("embed", "mlp"), "w_gate": ("embed", "mlp"),
            "w_down": ("mlp", "embed")},
    "moe": {"router": ("embed", "experts"),
            "w_up": ("experts", "embed", "mlp"),
            "w_gate": ("experts", "embed", "mlp"),
            "w_down": ("experts", "mlp", "embed")},
    "mamba": {"A_log": ("ssm_heads",), "D": ("ssm_heads",),
              "dt_bias": ("ssm_heads",), "conv_b": ("ssm_inner",),
              "conv_w": (None, "ssm_inner"),
              "in_proj": ("embed", "ssm_inner"), "norm": ("ssm_inner",),
              "out_proj": ("ssm_inner", "embed")},
    "frontend": {"conv1": (None, None, None, "embed"),
                 "conv2": (None, None, None, "embed"),
                 "patch": (None, None, None, "embed"),
                 "b1": ("embed",), "b2": ("embed",), "bias": ("embed",),
                 "cls": ("embed",), "pos": (None, "embed")},
}
_TOP_AXES = {"embed": ("vocab", "embed"), "lm_head": ("embed", "vocab"),
             "gate_attn": ()}


def param_axes(name: str) -> Tuple[Optional[str], ...]:
    """The logical axes of port parameter ``name`` (one per dimension)."""
    parts = name.split(".")
    if parts[0] in ("layers", "enc_layers"):
        parts = parts[2:]
    leaf = parts[-1]
    if len(parts) == 1:
        return _TOP_AXES[leaf]
    block = parts[-2]
    if block.endswith("norm") or block.startswith("norm"):
        return ("embed",)
    return _BLOCK_AXES[block][leaf]


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
            if layer.kind == "cross":
                put(layer.gate_attn, stack["gate_attn"][j])
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
        if cfg.frontend_conv:
            names = dict(model.frontend.named_parameters())
            if set(names) != set(tree["frontend"]):
                raise ValueError(f"frontend leaves {sorted(tree['frontend'])}"
                                 f" != {sorted(names)}")
            for key, p in names.items():
                put(p, tree["frontend"][key])
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


def opt_state_from_jax(state, model: Transformer, cfg: ModelConfig,
                       device=None) -> opt.OptState:
    """The port's :class:`~repro_torch.training.optimizer.OptState` for
    ``model``'s parameters from a JAX ``OptState`` of numpy-convertible
    leaves (``m``/``v`` trees over ``init_model``'s, ``step``), on
    ``device`` (None: the card).  Each moment keeps its dtype (bf16 or
    float32).  A factored ``{"row", "col"}`` leaf is split by layer like
    any stacked leaf, except a stacked 1-D leaf's ``col``, which all the
    layers of its period position share: each gets a copy."""
    dev = devmod.resolve(device)

    def leaf(tree, name):
        key, j = opt.stacked_leaf(name, cfg.period)
        for part in key.split("."):
            tree = tree[part]
        return tree, j

    def put(a, j=None):
        a = np.asarray(a)
        dt = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
        a = np.asarray(a if j is None else a[j], np.float32)
        return torch.from_numpy(a.copy()).to(dev, dt)

    m, v = {}, {}
    for n, p in model.named_parameters():
        a, j = leaf(state.m, n)
        m[n] = put(a, j)
        a, j = leaf(state.v, n)
        if isinstance(a, dict):
            v[n] = {"row": put(a["row"], j),
                    "col": put(a["col"], None if p.ndim == 1 else j)}
        else:
            v[n] = put(a, j)
    return opt.OptState(m=m, v=v, step=torch.tensor(
        int(np.asarray(state.step)), dtype=torch.int32, device=dev))
