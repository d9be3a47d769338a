"""Config registry: the ported architectures and their smoke variants."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, RunConfig, ServeConfig

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return get_config(f"{name}-smoke")


def _ensure_loaded():
    from repro_torch.configs import (  # noqa: F401
        mixtral_8x7b, nemotron_4_340b, qwen3_moe_235b_a22b, whisper_base)


__all__ = ["ModelConfig", "RunConfig", "ServeConfig", "get_config",
           "register", "smoke_config"]
