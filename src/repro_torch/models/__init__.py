"""The decoder-only dense model: norms, cache, attention, MLP, transformer."""
