"""Config dataclasses: model architecture and run knobs.

A copy of the JAX package's ``configs/base.py`` cut to the decoder-only
dense family this package serves.  Field names, defaults and the
dense-mode checks are the same, so one configuration means the same model
in both packages.
"""
from __future__ import annotations

import dataclasses
import warnings


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense (the only family ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // n_heads

    # attention
    rope_style: str = "half"       # half | 2d (chatglm) | none
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 = full attention
    # mlp
    mlp_type: str = "swiglu"       # relu2 | relu ported; swiglu | gelu not
    # dual-side sparsity dispatch: dense keeps plain torch.matmul;
    # weight/dual route every projection through repro_torch.sparse.
    sparse_mode: str = "dense"     # dense | weight | dual
    sparse_use_kernel: bool = False  # run the K1/K2 Hopper kernels
    # element-granular K-condensation (K2 instead of K1 under use_kernel)
    sparse_kcondense: bool = False
    sparse_block_m: int = 128
    sparse_block_n: int = 128
    sparse_slice_k: int = 128
    # sparse KV cache (repro_torch.sparse.kvcache): decode attention
    # schedules cache blocks from occupancy bitmaps ANDed with the
    # causal/window mask.  Effective only with a non-dense sparse_mode
    # (dense mode keeps plain caches).
    sparse_kv: bool = False        # SparseKVCache + bitmap-scheduled decode
    sparse_block_t: int = 32       # cache slots per occupancy block
    # norms
    norm_kind: str = "rms"         # rms | layer
    norm_eps: float = 1e-5

    def __post_init__(self):
        # sparse_use_kernel/sparse_kcondense only act on a condensed
        # schedule, which dense mode never builds: say so at the config
        # instead of silently running dense.
        if self.sparse_mode == "dense":
            ineffective = [
                ("sparse_use_kernel", self.sparse_use_kernel,
                 "the kernels only run condensed schedules"),
                ("sparse_kcondense", self.sparse_kcondense,
                 "there is no schedule to condense"),
            ]
            for flag, value, why in ineffective:
                if value:
                    warnings.warn(
                        f"ModelConfig(name={self.name!r}): {flag} has no "
                        f"effect with sparse_mode='dense' — {why}; all "
                        "matmuls will execute dense (executed == dense "
                        "steps)", RuntimeWarning, stacklevel=3)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kind(self, pos: int) -> str:
        """Layer type at position ``pos`` within the layer period."""
        return "attn"

    @property
    def period(self) -> int:
        """Length of the repeating layer pattern (1 for dense stacks)."""
        return 1

    @property
    def n_periods(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(f"n_layers {self.n_layers} is not a multiple "
                             f"of the period {self.period}")
        return self.n_layers // self.period


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution knobs this package reads."""
    act_dtype: str = "bfloat16"    # bfloat16 | float32
