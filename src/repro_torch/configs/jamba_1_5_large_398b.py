"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16
experts top-2 on every other layer (arXiv:2403.19887).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.  Period = 8
(1 attn + 7 mamba; MoE at odd positions).  Mamba blocks use the SSD
formulation (state 128, head_dim 64 → 256 SSD heads), the chunked scan of
:mod:`repro_torch.models.ssm`.
Hybrid: attention KV grows only in 9 of 72 layers → long_500k runnable.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        n_experts=16,
        n_experts_active=2,
        moe_every=2,
        moe_offset=1,
        attn_every=8,          # 1:7 attn:mamba
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_groups=1,
        ssm_conv=4,
        ssm_chunk=64,
        rope_style="none",     # jamba uses no positional encoding
        mlp_type="swiglu",
        subquadratic=True,
    ),
    run_overrides={
        "train_4k": dict(microbatches=16, optimizer="adafactor",
                         accum_dtype="bfloat16"),
        "decode_32k": dict(kv_quant=True),
        "long_500k": dict(kv_quant=True),
    })

SMOKE = register(
    ModelConfig(
        name="jamba-1.5-large-398b-smoke",
        family="hybrid",
        n_layers=16,           # 2 periods of 8
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        n_experts=4,
        n_experts_active=2,
        moe_every=2,
        moe_offset=1,
        attn_every=8,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=16,
        ssm_groups=1,
        ssm_conv=4,
        ssm_chunk=8,
        rope_style="none",
        mlp_type="swiglu",
        subquadratic=True,
    ))
