"""Config dataclasses: model architecture and run knobs.

A copy of the JAX package's ``configs/base.py`` cut to the families this
package serves: the decoder-only dense and mixture-of-experts families,
the attention-free Mamba2 family (``ssm``), the Mamba/attention hybrid
with MoE on some layers (``hybrid``), the audio encoder-decoder with its
conv stem or its stub, and the VLM (``vlm``): tanh-gated cross layers
over image embeddings from the patch-conv vision frontend or its stub.
Field names, defaults, the layer pattern (``layer_kind``,
``layer_is_moe``, ``period``) and the frontend and dense-mode checks are
the same, so one configuration means the same model in both packages;
the shapes table and the run knobs likewise.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // n_heads

    # attention
    rope_style: str = "half"       # half | 2d (chatglm) | none
    abs_positions: bool = False    # sinusoidal absolute positions (whisper)
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    sliding_window: int = 0        # 0 = full attention
    # mlp
    mlp_type: str = "swiglu"       # swiglu | relu2 | gelu | relu
    # moe
    n_experts: int = 0
    n_experts_active: int = 0
    moe_every: int = 1             # MoE at layer positions p % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 64
    attn_every: int = 0            # hybrid: attention at p % attn_every == 0
    # enc-dec / multimodal: with frontend_conv the model consumes raw mel
    # frames / images through a conv stem (repro_torch.models.frontend),
    # routed through repro_torch.sparse.conv; without it the frontend is
    # the stub fed precomputed embeddings ("frames" / "image_embeds")
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 0           # encoder positions (mel frames / 2)
    cross_attn_every: int = 0      # vlm: cross-attn at p % cross_attn_every == 0
    num_image_tokens: int = 0
    frontend: str = "none"         # none | audio | vision
    frontend_conv: bool = False
    n_mels: int = 0                # audio: mel bins into the conv stem
    image_size: int = 0            # vision: square input image extent
    patch_size: int = 0            # vision: patch conv kernel == stride
    image_channels: int = 3        # vision: input channels
    # dual-side sparsity dispatch: dense keeps plain torch.matmul;
    # weight/dual route every projection through repro_torch.sparse.
    sparse_mode: str = "dense"     # dense | weight | dual
    sparse_use_kernel: bool = False  # run the Hopper kernels (K1/K2, K5-K7)
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
    # per-call autotuning (repro_torch.sparse.autotune): consult the
    # persistent tuning cache per dispatch; the sparse_block_*/slice_k/
    # use_kernel/kcondense constants above become the fallback tier on a
    # cache miss.
    sparse_autotune: bool = False
    sparse_tune_cache: str = ""    # cache file to load ("" = in-memory)
    # static activation-sparsity hint the cache keys bucket under
    # (< 0 = no hint → the 'any' bucket)
    sparse_tune_sparsity: float = -1.0
    # OpSite resolution tier 2 (repro_torch.sparse.site): on a
    # tuning-cache miss, take the cost model's best candidate instead of
    # the config constants.  Off by default, so an untuned run executes
    # the hand-set geometry.
    sparse_costmodel: bool = False
    # norms
    norm_kind: str = "rms"         # rms | layer
    norm_eps: float = 1e-5
    tie_embeddings: bool = False   # the head is embed.T (no lm_head)
    # sub-quadratic capability (decides long_500k applicability)
    subquadratic: bool = False

    def __post_init__(self):
        # conv-frontend geometry must be consistent at config time, not
        # fail as a shape error deep in the encoder or cross-attention
        if self.frontend_conv:
            if self.frontend == "audio" and self.n_mels <= 0:
                raise ValueError(
                    f"ModelConfig(name={self.name!r}): frontend_conv audio "
                    "requires n_mels > 0")
            if self.frontend == "vision":
                if self.patch_size <= 0 or self.image_size % self.patch_size:
                    raise ValueError(
                        f"ModelConfig(name={self.name!r}): frontend_conv "
                        f"vision requires patch_size dividing image_size, "
                        f"got {self.image_size}/{self.patch_size}")
                g = self.image_size // self.patch_size
                if self.num_image_tokens not in (g * g, g * g + 1):
                    raise ValueError(
                        f"ModelConfig(name={self.name!r}): num_image_tokens "
                        f"({self.num_image_tokens}) must be {g * g} (patch "
                        f"grid) or {g * g + 1} (grid + cls token)")
            if self.frontend == "none":
                raise ValueError(
                    f"ModelConfig(name={self.name!r}): frontend_conv "
                    "requires frontend='audio'|'vision'")
        # sparse_use_kernel/sparse_kcondense only act on a condensed
        # schedule, which dense mode never builds: say so at the config
        # instead of silently running dense.
        if self.sparse_mode == "dense":
            ineffective = [
                ("sparse_use_kernel", self.sparse_use_kernel,
                 "the kernels only run condensed schedules"),
                ("sparse_kcondense", self.sparse_kcondense,
                 "there is no schedule to condense"),
                ("sparse_autotune", self.sparse_autotune,
                 "dense mode never consults the tuning cache"),
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

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def layer_kind(self, pos: int) -> str:
        """Layer type at position ``pos`` within the layer period."""
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid":
            return "attn" if pos % self.attn_every == 0 else "mamba"
        if self.cross_attn_every:
            return "cross" if pos % self.cross_attn_every == 0 else "attn"
        return "attn"

    def layer_is_moe(self, pos: int) -> bool:
        """Whether the layer at ``pos`` holds a MoE in place of its MLP."""
        if not self.n_experts:
            return False
        return pos % self.moe_every == self.moe_offset

    @property
    def period(self) -> int:
        """Length of the repeating layer pattern: 1 for the dense, MoE,
        ssm and audio families, ``attn_every`` for a hybrid,
        ``cross_attn_every`` for a VLM, widened to the lcm with
        ``moe_every`` where MoE skips layers."""
        p = 1
        if self.family == "hybrid" and self.attn_every:
            p = self.attn_every
        if self.cross_attn_every:
            p = self.cross_attn_every
        if self.n_experts and self.moe_every > 1:
            p = _lcm(p, self.moe_every)
        return p

    @property
    def n_periods(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(f"n_layers {self.n_layers} is not a multiple "
                             f"of the period {self.period}")
        return self.n_layers // self.period


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution knobs per (arch x shape): the JAX package's, less its XLA
    and mesh knobs (``scan_unroll``, ``decode_2d``, ``seq_shard``,
    ``latency_flags``).  Serving reads ``act_dtype``, ``kv_quant`` and
    ``attn_chunk``; training (:mod:`repro_torch.training`) reads
    ``microbatches``, ``act_dtype`` (bf16 compute copies of the float32
    masters), ``accum_dtype``, ``remat``, ``optimizer`` and the schedule's
    ``learning_rate``, ``weight_decay``, ``warmup_steps`` and
    ``grad_clip``.  The masters are always float32, so the JAX package's
    ``param_dtype`` (which only its dry-run cost model reads) has no
    counterpart."""
    microbatches: int = 1          # gradient-accumulation steps
    act_dtype: str = "bfloat16"    # bfloat16 | float32
    accum_dtype: str = "float32"   # gradient-accumulator dtype
    remat: str = "full"            # full | dots | none
    optimizer: str = "adamw"       # adamw | adamw_bf16 | adafactor
    kv_quant: bool = False         # int8 KV cache
    # run the repro_torch.sparse.validate invariant checks at dispatch
    # boundaries and engine ticks (debug mode; the effect of
    # REPRO_VALIDATE=1, scoped to this run)
    validate: bool = False
    attn_chunk: int = 2048         # KV-chunked attention threshold/size
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    grad_clip: float = 1.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """A device mesh's shape and axis names: (16, 16) over ("data",
    "model") is one pod, (2, 16, 16) over ("pod", "data", "model") two."""
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching engine knobs (:mod:`repro_torch.serving`).

    The engine decodes a fixed ``slots``-wide batch in one step; every
    slot's KV history lives in pages of one shared physical pool
    (``pages`` × ``page_size`` cache slots) indexed through a per-slot
    block table, so freed pages recycle across requests and the pool may
    be over-subscribed (``pages`` < ``slots`` × blocks-per-slot) with
    preemption on exhaustion.
    """
    slots: int = 4
    capacity: int = 256        # logical per-slot cache slots (rounded up
                               # to a page multiple)
    page_size: int = 0         # cache slots per page; 0 → sparse_block_t
                               # (page occupancy ≡ the level-2 bitmap)
    pages: int = 0             # physical pool pages; 0 → fully
                               # provisioned (slots × capacity/page_size)
    prefill_bucket: int = 0    # pad prompts up to a bucket multiple;
                               # 0 → page_size (exact length for MoE
                               # models — token-count-dependent expert
                               # capacity makes padding non-neutral)
    max_prefill_batch: int = 4  # same-bucket admissions packed into one
                                # batched prefill call
    policy: str = "fcfs"       # admission order: fcfs | cost (cheapest
                               # estimated sparse compute first, from the
                               # StepCounts tape)
    eos_id: int = -1
    # robustness knobs
    alloc_retries: int = 3     # bounded reclaim/evict attempts per page
                               # allocation before the slot self-preempts
    backoff_ticks: int = 2     # base requeue backoff after a failed
                               # allocation (doubles per retry, capped)
    watchdog_ticks: int = 200  # no-progress ticks before
                               # run_to_completion raises EngineStalled
                               # with a health snapshot; 0 disables
