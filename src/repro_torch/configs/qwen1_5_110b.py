"""qwen1.5-110b [dense] — GQA, QKV bias (hf:Qwen/Qwen1.5-110B family).

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=49152,
        vocab_size=152064,
        qkv_bias=True,
        rope_style="half",
        rope_theta=1_000_000.0,
        mlp_type="swiglu",
    ),
    run_overrides={
        "train_4k": dict(microbatches=16, optimizer="adamw_bf16",
                         accum_dtype="bfloat16"),
        "prefill_32k": dict(),
        "decode_32k": dict(kv_quant=True),
    })

SMOKE = register(
    ModelConfig(
        name="qwen1.5-110b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        rope_style="half",
        rope_theta=1_000_000.0,
        mlp_type="swiglu",
    ))
