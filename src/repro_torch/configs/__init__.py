"""Config registry: the ported architectures, their smoke variants and
the per-(arch, shape) run table."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (ModelConfig, RunConfig, SHAPES,
                                      SHAPES_BY_NAME, ServeConfig,
                                      ShapeConfig)

_REGISTRY: Dict[str, ModelConfig] = {}
_RUN_OVERRIDES: Dict[str, Dict[str, dict]] = {}


def register(cfg: ModelConfig, run_overrides: Dict[str, dict] = None
             ) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _RUN_OVERRIDES[cfg.name] = run_overrides or {}
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(k for k in _REGISTRY if not k.endswith("-smoke"))


def get_run_config(name: str, shape: str) -> RunConfig:
    """Per-(arch, shape) execution policy: the arch's overrides for that
    shape over the :class:`RunConfig` defaults."""
    _ensure_loaded()
    overrides = _RUN_OVERRIDES.get(name, {}).get(shape, {})
    return RunConfig(**overrides)


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return get_config(f"{name}-smoke")


def runnable_shapes(name: str) -> List[ShapeConfig]:
    """The assigned shapes this arch runs: ``long_500k`` needs
    sub-quadratic attention."""
    cfg = get_config(name)
    return [s for s in SHAPES
            if s.name != "long_500k" or cfg.subquadratic]


def _ensure_loaded():
    from repro_torch.configs import (  # noqa: F401
        chatglm3_6b, jamba_1_5_large_398b, llama3_2_vision_90b, mamba2_370m,
        mixtral_8x7b, nemotron_4_340b, qwen1_5_110b, qwen3_moe_235b_a22b,
        whisper_base, yi_34b)


__all__ = ["ModelConfig", "RunConfig", "SHAPES", "SHAPES_BY_NAME",
           "ServeConfig", "ShapeConfig", "get_config", "get_run_config",
           "list_archs", "register", "runnable_shapes", "smoke_config"]
