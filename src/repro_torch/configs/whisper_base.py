"""whisper-base [audio] — enc-dec transformer with the two-conv mel stem
(arXiv:2212.04356): 80 mel bins, conv k=3 s=1 + conv k=3 s=2 (GeLU),
3000 frames → 1500 encoder positions, routed through
repro_torch.sparse.conv.

6L (encoder) + 6L (decoder), d_model=512 8H (kv=8, MHA) d_ff=2048
vocab=51865; GeLU MLP, LayerNorm, sinusoidal positions (no RoPE).
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        is_encoder_decoder=True,
        n_encoder_layers=6,
        encoder_len=1500,      # 30 s of audio at 50 Hz (3000 mel frames)
        frontend="audio",
        frontend_conv=True,
        n_mels=80,
        rope_style="none",
        abs_positions=True,
        mlp_type="gelu",
        norm_kind="layer",
        norm_eps=1e-5,
    ),
    run_overrides={
        "train_4k": dict(microbatches=4),
    })

SMOKE = register(
    ModelConfig(
        name="whisper-base-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        is_encoder_decoder=True,
        n_encoder_layers=2,
        encoder_len=24,
        frontend="audio",
        frontend_conv=True,
        n_mels=16,
        rope_style="none",
        abs_positions=True,
        mlp_type="gelu",
        norm_kind="layer",
    ))
