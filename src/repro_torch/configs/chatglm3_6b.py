"""chatglm3-6b [dense] — RoPE 2d (half-dim rotary), GQA kv=2, QKV bias
(arXiv:2406.12793).

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="chatglm3-6b",
        family="dense",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        qkv_bias=True,
        rope_style="2d",
        mlp_type="swiglu",
    ),
    run_overrides={
        "train_4k": dict(microbatches=8),
    })

SMOKE = register(
    ModelConfig(
        name="chatglm3-6b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        rope_style="2d",
        mlp_type="swiglu",
    ))
