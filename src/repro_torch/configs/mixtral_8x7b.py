"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention
(arXiv:2401.04088).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000; SWA window 4096
makes the KV cache O(window) → long_500k runnable.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        n_experts=8,
        n_experts_active=2,
        sliding_window=4096,
        rope_style="half",
        rope_theta=1_000_000.0,
        mlp_type="swiglu",
        subquadratic=True,     # SWA: long_500k decodes against the window
    ),
    run_overrides={
        "train_4k": dict(microbatches=16, optimizer="adamw_bf16"),
    })

SMOKE = register(
    ModelConfig(
        name="mixtral-8x7b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        n_experts=4,
        n_experts_active=2,
        sliding_window=16,
        rope_style="half",
        mlp_type="swiglu",
        subquadratic=True,
    ))
