"""repro_torch — the PyTorch/CUDA port of the dual-side sparse repro.

A second package beside the JAX package ``repro``, which stays the
reference.  It imports ``torch`` and numpy only, never ``jax`` and never
``repro``.  Each module mirrors the JAX module of the same path; where
PyTorch idiom differs, the counterpart is:

* ``models.transformer.forward`` → ``Transformer.forward`` (its
  encoder half → ``Transformer.encode``); ``_apply_layer`` →
  ``DecoderLayer.forward``;
* ``models.frontend`` params → ``AudioFrontend``;
  ``attention.attention_forward`` → ``Attention.forward``;
  ``mlp.init_mlp``/``mlp_forward`` → ``MLP`` and ``MLP.forward``;
* ``lax.scan`` over layers or decode steps → a Python loop;
* ``jax.random`` keys → an explicit ``torch.Generator``.

Entry points (``init_model``, ``generate``, the kernel wrappers) take
``device=None``, which means the card, and raise without one.
"""
