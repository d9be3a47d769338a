"""Load the JAX package's ``init_model`` parameters into the port.

The JAX pytree is layer-stacked: ``params["layers"]["pos0"][...]`` has a
leading ``n_periods`` axis (the period is 1 for the dense family), which
is unstacked here into the port's per-layer modules.  Layouts are the
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

    with torch.no_grad():
        put(model.embed, tree["embed"])
        put(model.final_norm["scale"], tree["final_norm"]["scale"])
        put(model.lm_head, tree["lm_head"])
        stack = tree["layers"]["pos0"]
        for i, layer in enumerate(model.layers):
            for norm in ("norm1", "norm2"):
                for key, p in getattr(layer, norm).items():
                    put(p, stack[norm][key][i])
            for key in ("wq", "wk", "wv", "wo"):
                put(getattr(layer.attn, key), stack["attn"][key][i])
            for key in ("w_up", "w_down"):
                put(getattr(layer.mlp, key), stack["mlp"][key][i])
    return model
