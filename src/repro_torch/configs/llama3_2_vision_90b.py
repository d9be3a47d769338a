"""llama-3.2-vision-90b [vlm] — cross-attention image layers every 5th
layer (hf:meta-llama/Llama-3.2-90B-Vision).  The vision tower is the
patch-conv frontend of :mod:`repro_torch.models.frontend`: 560×560
images, 14×14 patch conv (k == stride) → 40×40 grid + cls = 1601 tokens,
routed through :mod:`repro_torch.sparse.conv` (K5 → K7 → K1/K2 in the
sparse modes).

100L (20 cross + 80 self) d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        cross_attn_every=5,
        num_image_tokens=1601,  # 40×40 patch grid + cls
        frontend="vision",
        frontend_conv=True,
        image_size=560,
        patch_size=14,
        rope_style="half",
        rope_theta=500_000.0,
        mlp_type="swiglu",
    ),
    run_overrides={
        "train_4k": dict(microbatches=16, optimizer="adamw_bf16",
                         accum_dtype="bfloat16"),
        "decode_32k": dict(kv_quant=True),
    })

SMOKE = register(
    ModelConfig(
        name="llama-3.2-vision-90b-smoke",
        family="vlm",
        n_layers=10,            # 2 periods of 5
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        cross_attn_every=5,
        num_image_tokens=16,    # 4×4 patch grid, no cls
        frontend="vision",
        frontend_conv=True,
        image_size=16,
        patch_size=4,
        rope_style="half",
        mlp_type="swiglu",
    ))
