"""mamba2-370m [ssm] — SSD, attention-free (arXiv:2405.21060).

48L d_model=1024, d_ff=0 (single Mamba2 block per layer), vocab=50280,
ssm_state=128; expand 2 → d_inner 2048, head_dim 64 → 32 SSD heads.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=1,            # unused: attention-free
        n_kv_heads=1,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_groups=1,
        ssm_conv=4,
        ssm_chunk=64,
        tie_embeddings=True,
        subquadratic=True,    # runs long_500k (O(1) state decode)
        rope_style="none",
    ),
    run_overrides={"train_4k": dict(microbatches=4)},
)

SMOKE = register(
    ModelConfig(
        name="mamba2-370m-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=512,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=16,
        ssm_groups=1,
        ssm_conv=4,
        ssm_chunk=8,
        tie_embeddings=True,
        subquadratic=True,
        rope_style="none",
    ))
