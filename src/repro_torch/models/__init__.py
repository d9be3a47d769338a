"""The models: norms, caches, attention, MLP, MoE, the Mamba2 block, the
audio and vision frontends and the transformer (decoder-only dense, MoE,
Mamba2 and hybrid stacks, the audio encoder-decoder and the VLM)."""
