"""yi-34b [dense] — llama-arch GQA (arXiv:2403.04652).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="yi-34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        rope_style="half",
        rope_theta=5_000_000.0,
        mlp_type="swiglu",
    ),
    run_overrides={
        "train_4k": dict(microbatches=16, optimizer="adamw_bf16"),
    })

SMOKE = register(
    ModelConfig(
        name="yi-34b-smoke",
        family="dense",
        n_layers=2,
        d_model=56,
        n_heads=7,
        n_kv_heads=1,
        d_ff=112,
        vocab_size=512,
        rope_style="half",
        rope_theta=5_000_000.0,
        mlp_type="swiglu",
    ))
