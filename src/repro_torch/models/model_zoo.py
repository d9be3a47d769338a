"""Build models and input specs for every ported architecture: the JAX
package's ``models/model_zoo.py``.

Where the JAX package returns ``jax.ShapeDtypeStruct`` stand-ins, these
return tensors on the ``meta`` device, which carry a shape and a dtype
and allocate nothing.  ``abstract_params`` returns the logical specs
beside them, keyed by the port's parameter names
(``convert.param_axes``), for ``distributed.sharding.tree_pspecs``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import device as devmod
from repro_torch.models import transformer
from repro_torch.models.convert import param_axes

META = torch.device("meta")


def build_model(cfg: ModelConfig, seed: int = 0, *, device=None
                ) -> transformer.Transformer:
    """The model of ``cfg`` on ``device`` (None: the card), its float32
    weights (the JAX package's parameters, the training masters) drawn
    from a generator on that device seeded ``seed``."""
    dev = devmod.resolve(device)
    return transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev,
        dtype=torch.float32)


def abstract_params(cfg: ModelConfig
                    ) -> Tuple[transformer.Transformer, Dict[str, tuple]]:
    """(the float32 model of ``cfg`` on the meta device: every parameter's
    shape and dtype, no storage; {parameter name: logical axes}), as the
    JAX package returns (shapes, logical specs)."""
    model = transformer.Transformer(cfg, device=META, dtype=torch.float32)
    return model, {n: param_axes(n) for n, _ in model.named_parameters()}


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input of a cell.

    train:   tokens + labels (+ the frontend's input)
    prefill: tokens (+ the frontend's input)
    decode:  single-token step inputs (the caches: :func:`cache_specs`).
    """
    b, s = shape.global_batch, shape.seq_len

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=META)
    specs: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        specs["tokens"] = spec((b, s))
        specs["labels"] = spec((b, s))
    elif shape.kind == "prefill":
        specs["tokens"] = spec((b, s))
    else:  # decode: one new token against a cache of length s
        specs["tokens"] = spec((b, 1))
    if shape.kind == "decode":
        return specs
    bf16 = torch.bfloat16
    if cfg.frontend == "audio":
        if cfg.frontend_conv:
            specs["mel"] = spec((b, 2 * cfg.encoder_len, cfg.n_mels), bf16)
        else:
            specs["frames"] = spec((b, cfg.encoder_len, cfg.d_model), bf16)
    if cfg.frontend == "vision":
        if cfg.frontend_conv:
            specs["images"] = spec((b, cfg.image_size, cfg.image_size,
                                    cfg.image_channels), bf16)
        else:
            specs["image_embeds"] = spec(
                (b, cfg.num_image_tokens, cfg.d_model), bf16)
    return specs


def frontend_inputs(cfg: ModelConfig, b: int, *, seed: int = 0,
                    dtype=torch.bfloat16, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Concrete frontend inputs for a ``b``-wide prefill batch on
    ``device`` (None: the card), drawn from a generator on that device
    seeded ``seed``.

    Conv frontends get ReLU-clipped normals (zero-heavy raw inputs, so
    the implicit-im2col dual-side path has real sparsity to skip); stub
    frontends get plain normals.  Decode steps take no frontend input.
    The values are not the JAX package's (``jax.random`` draws other
    numbers); parity tests feed both packages numpy inputs.
    """
    if cfg.frontend == "none":
        return {}
    dev = devmod.resolve(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*dims):
        return torch.randn(dims, generator=g, device=dev)
    if cfg.frontend == "audio":
        if cfg.frontend_conv:
            x = normal(b, 2 * cfg.encoder_len, cfg.n_mels)
            return {"mel": torch.clamp(x, min=0).to(dtype)}
        return {"frames": normal(b, cfg.encoder_len, cfg.d_model).to(dtype)}
    if cfg.frontend_conv:
        x = normal(b, cfg.image_size, cfg.image_size, cfg.image_channels)
        return {"images": torch.clamp(x, min=0).to(dtype)}
    return {"image_embeds": normal(b, cfg.num_image_tokens,
                                   cfg.d_model).to(dtype)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                quantized: bool = False) -> List:
    """Meta caches of a decode cell (capacity = seq_len): one per decoder
    layer, as ``transformer.init_caches`` builds them."""
    return transformer.init_caches(cfg, shape.global_batch, shape.seq_len,
                                   quantized=quantized, device=META)
