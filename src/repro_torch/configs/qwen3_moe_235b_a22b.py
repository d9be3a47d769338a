"""qwen3-moe-235b-a22b [moe] — 128 experts top-8
(hf:Qwen/Qwen3-30B-A3B scaled family; head_dim=128 per HF config).

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151936,
        n_experts=128,
        n_experts_active=8,
        capacity_factor=1.0,   # dispatch-buffer memory bound
        rope_style="half",
        rope_theta=1_000_000.0,
        mlp_type="swiglu",
    ),
    run_overrides={
        "train_4k": dict(microbatches=16, optimizer="adamw_bf16",
                         accum_dtype="bfloat16"),
        "decode_32k": dict(kv_quant=True),
    })

SMOKE = register(
    ModelConfig(
        name="qwen3-moe-235b-a22b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=512,
        n_experts=8,
        n_experts_active=2,
        capacity_factor=1.0,
        rope_style="half",
        mlp_type="swiglu",
    ))
