"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP (arXiv:2402.16819).

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.

Squared-ReLU gives genuine activation zeros, so this is the architecture
on which dual-side sparse inference does real work.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(
    ModelConfig(
        name="nemotron-4-340b",
        family="dense",
        n_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        d_ff=73728,
        vocab_size=256000,
        rope_style="half",
        mlp_type="relu2",
    ),
    run_overrides={
        "train_4k": dict(microbatches=16, optimizer="adafactor",
                         accum_dtype="bfloat16"),
        "decode_32k": dict(kv_quant=True),
    })

SMOKE = register(
    ModelConfig(
        name="nemotron-4-340b-smoke",
        family="dense",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=384,
        vocab_size=512,
        rope_style="half",
        mlp_type="relu2",
    ))
