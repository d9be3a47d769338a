"""The models: norms, caches, attention, MLP, the audio frontend and the
transformer (decoder-only dense, and the audio encoder-decoder)."""
