"""The analytic step model: the JAX package's ``launch/costmodel.py``.

:func:`step_costs` gives a cell's per-device FLOPs, HBM bytes and
collective bytes for one step from its configuration alone, whatever
runs it: the dry run's roofline terms, and a count of a step's work that
stays the same across implementations.  Pure arithmetic over the port's
own configs, equal to the JAX package's bit for bit.  The sharding it
assumes is the JAX package's (dp = data[×pod], tp = model).  The port's
:class:`~repro_torch.configs.base.RunConfig` has no ``param_dtype`` (the
masters are float32, the JAX default) and no ``decode_2d`` (the
``decode_2d`` keyword stands in for it).

:func:`sparse_step_fraction` and :func:`predict_sparse_steps` give the
expected executed-step fraction of a dual-side sparse schedule, which the
autotuner's scorer folds into
:func:`repro_torch.launch.roofline.sparse_matmul`.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig

BF16 = 2
F32 = 4


def _param_counts(cfg: ModelConfig) -> Dict[str, float]:
    """Parameter counts by role (matches init_model arithmetic)."""
    d, hd = cfg.d_model, cfg.hd
    h, kv = cfg.n_heads, cfg.n_kv_heads
    attn = d * hd * (h + 2 * kv) + h * hd * d  # q,k,v,o
    mlp_mults = 3 if cfg.mlp_type == "swiglu" else 2
    mlp = mlp_mults * d * cfg.d_ff
    moe = cfg.n_experts * mlp + d * cfg.n_experts if cfg.n_experts else 0
    g, n = cfg.ssm_groups, cfg.ssm_state
    din = cfg.d_inner
    mamba = (d * (2 * din + 2 * g * n + cfg.ssm_heads)   # in_proj
             + din * d) if cfg.ssm_state else 0          # out_proj

    per_layer = {"attn": 0.0, "mlp": 0.0, "moe": 0.0, "mamba": 0.0}
    for pos in range(cfg.period):
        kind = cfg.layer_kind(pos)
        if kind in ("attn", "cross"):
            per_layer["attn"] += attn
        if kind == "mamba":
            per_layer["mamba"] += mamba
        if kind != "mamba" or cfg.family != "ssm":
            if cfg.layer_is_moe(pos):
                per_layer["moe"] += moe
            else:
                per_layer["mlp"] += mlp
        if cfg.is_encoder_decoder:
            per_layer["attn"] += attn  # decoder cross-attn
    for k in per_layer:
        per_layer[k] *= cfg.n_periods
    if cfg.is_encoder_decoder:
        per_layer["attn"] += cfg.n_encoder_layers * attn
        per_layer["mlp"] += cfg.n_encoder_layers * mlp
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    total = sum(per_layer.values()) + embed
    active = total - per_layer["moe"] * (
        1 - cfg.n_experts_active / cfg.n_experts) if cfg.n_experts else total
    return {"total": total, "active": active, "embed": embed, **per_layer}


def step_costs(cfg: ModelConfig, shape: ShapeConfig, rc: RunConfig, *,
               dp: int = 16, tp: int = 16, decode_2d: bool = False
               ) -> Dict[str, float]:
    """Per-device (flops, hbm_bytes, collective_bytes) for one step;
    ``decode_2d`` is the JAX ``RunConfig.decode_2d`` (2-D weight sharding
    at decode)."""
    pc = _param_counts(cfg)
    n_dev = dp * tp
    s = shape.seq_len
    if shape.kind == "train":
        tokens = shape.global_batch * s
    elif shape.kind == "prefill":
        tokens = shape.global_batch * s
    else:
        tokens = shape.global_batch  # one new token per sequence

    # ---------- FLOPs ----------
    # matmul forward flops: 2 per param per token on active params
    f_fwd = 2.0 * pc["active"] * tokens
    # attention score/value flops per token: 4 · S_ctx · h · hd per layer
    n_attn_layers = _attn_layer_count(cfg)
    ctx = {"train": s / 2, "prefill": s / 2, "decode": s}[shape.kind]
    if cfg.sliding_window:
        ctx = min(ctx, cfg.sliding_window)
    f_attn = 4.0 * ctx * cfg.n_heads * cfg.hd * tokens * n_attn_layers
    # SSD core flops per token per mamba layer: intra-chunk L·(h·p) terms
    n_mamba = _mamba_layer_count(cfg)
    if n_mamba and shape.kind != "decode":
        f_ssm = (4.0 * cfg.ssm_chunk * cfg.d_inner
                 + 8.0 * cfg.d_inner * cfg.ssm_state) * tokens * n_mamba
    elif n_mamba:
        f_ssm = 6.0 * cfg.d_inner * cfg.ssm_state * tokens * n_mamba
    else:
        f_ssm = 0.0
    fwd = f_fwd + f_attn + f_ssm
    if shape.kind == "train":
        remat_extra = 1.0 if rc.remat == "full" else 0.0
        flops_total = fwd * (3.0 + remat_extra)  # fwd + bwd(2×) + recompute
    else:
        flops_total = fwd
    flops = flops_total / n_dev

    # ---------- HBM bytes ----------
    decode_2d = shape.kind == "decode" and decode_2d
    # float32 masters in training (the JAX default param_dtype), bf16
    # weights in serving
    pbytes_dev = pc["total"] * (F32 if shape.kind == "train"
                                else BF16) / n_dev
    k = rc.microbatches if shape.kind == "train" else 1
    # weights streamed per microbatch; fwd + recompute + bwd ≈ 3 passes
    passes = 3.0 if shape.kind == "train" else 1.0
    b_weights = pbytes_dev * passes * k
    # activations: ~8 residual-stream touches per layer per pass
    tok_dev = tokens / dp if shape.kind != "decode" else tokens / dp
    b_act = 8.0 * cfg.n_layers * tok_dev * cfg.d_model * BF16 * passes / tp
    # KV cache traffic
    kv_bytes_tok = 2 * cfg.n_kv_heads * cfg.hd * (1 if rc.kv_quant else BF16)
    if shape.kind == "decode":
        cache_dev = (shape.global_batch * s * kv_bytes_tok
                     * n_attn_layers / n_dev)
        b_kv = cache_dev  # read whole cache per token step
    else:
        b_kv = tok_dev * kv_bytes_tok * n_attn_layers
    # optimizer state read+write
    if shape.kind == "train":
        opt_mult = {"adamw": 4, "adamw_bf16": 2, "adafactor": 1}[
            rc.optimizer]
        b_opt = 2.0 * pc["total"] * opt_mult * 2 / n_dev
    else:
        b_opt = 0.0
    hbm = b_weights + b_act + b_kv + b_opt

    # ---------- collective bytes ----------
    if shape.kind == "train":
        # FSDP all-gather (bf16 compute copies) per pass per microbatch
        # + grad reduce-scatter once (accum dtype), per device receive.
        ag = pc["total"] * BF16 / tp * (dp - 1) / dp * 2.0 * k
        acc_b = BF16 if rc.accum_dtype == "bfloat16" else F32
        rs = pc["total"] * acc_b / tp * (dp - 1) / dp
        # TP collectives: 2 reduce-ops per layer per microbatch pass
        # (attention out + mlp out), payload = local tokens × d.
        tp_coll = (2.0 * cfg.n_layers * (tokens / dp) * cfg.d_model
                   * BF16 / tp * 2.0  # AR ≈ 2× payload (or AG+RS with SP)
                   * 2.0)             # fwd + bwd
        coll = ag + rs + tp_coll
    elif shape.kind == "prefill":
        ag = pc["total"] * BF16 / tp * (dp - 1) / dp
        tp_coll = 2.0 * cfg.n_layers * (tokens / dp) * cfg.d_model * BF16 \
            / tp * 2.0
        coll = ag + tp_coll
    elif decode_2d:
        # 2-D-sharded weights: no weight gather; activations (replicated
        # on data) all-reduce across the whole mesh after attn/mlp.
        tp_coll = 2.0 * cfg.n_layers * tokens * cfg.d_model * BF16 * 2.0
        kv_comb = tokens / dp * cfg.n_heads * cfg.hd * F32 * 2.0 \
            * _attn_layer_count(cfg) / max(tp, 1)
        coll = tp_coll + kv_comb
    else:
        # weight-gathered decode: params cross the data axis each step
        ag = pc["active"] * BF16 / tp * (dp - 1) / dp
        tp_coll = 2.0 * cfg.n_layers * (tokens / dp) * cfg.d_model * BF16 \
            / tp * 2.0
        # seq-sharded KV attention: logits/LSE combine over model axis
        kv_comb = tokens / dp * cfg.n_heads * cfg.hd * F32 * 2.0 \
            * _attn_layer_count(cfg) / max(tp, 1)
        coll = ag + tp_coll + kv_comb
    return {
        "flops_per_device": flops,
        "hbm_bytes_per_device": hbm,
        "coll_bytes_per_device": coll,
        "model_flops_total": (6.0 if shape.kind == "train" else 2.0)
        * pc["active"] * tokens + (2.0 if shape.kind == "train" else 1.0)
        * f_attn,
        "hw_flops_total": flops_total,
        "params_total": pc["total"],
        "params_active": pc["active"],
    }


def sparse_step_fraction(block_m: int, block_n: int, slice_k: int, k: int,
                         *, a_density: float = 1.0, w_density: float = 1.0,
                         condense=None) -> float:
    """Expected executed-step fraction of a dual-side sparse schedule,
    under an iid-Bernoulli element model: each A element non-zero with
    probability ``a_density``, each B element with ``w_density``.

    Slice-granular (``condense=None``): a (block, slice) pair is active
    iff any of its block_m·slice_k A elements (block_n·slice_k B
    elements) is non-zero, and a step executes iff both sides are active
    — fraction = p_A · p_B.

    Element-granular (``condense="k"``): contraction index k survives the
    AND iff some A row and some B column of the block are non-zero there;
    executed steps are ceil(nnz_AND / slice_k), so the fraction is nnz/K,
    at least one step's worth when anything survives.
    """
    a = min(max(float(a_density), 0.0), 1.0)
    w = min(max(float(w_density), 0.0), 1.0)
    s = max(-(-k // slice_k), 1)
    if condense == "k":
        p_a = 1.0 - (1.0 - a) ** block_m
        p_b = 1.0 - (1.0 - w) ** block_n
        nnz = k * p_a * p_b
        if nnz <= 0.0:
            return 0.0
        return min(max(nnz / slice_k, 1.0), float(s)) / s
    p_a = 1.0 - (1.0 - a) ** (block_m * slice_k)
    p_b = 1.0 - (1.0 - w) ** (block_n * slice_k)
    return p_a * p_b


def predict_sparse_steps(m: int, n: int, k: int, block_m: int, block_n: int,
                         slice_k: int, *, a_density: float = 1.0,
                         w_density: float = 1.0, condense=None
                         ) -> Dict[str, float]:
    """StepCounts-shaped prediction for one (m, n, k) matmul: dense grid
    steps, predicted executed steps and the executed fraction."""
    mt = -(-m // block_m)
    nt = -(-n // block_n)
    s = -(-k // slice_k)
    frac = sparse_step_fraction(block_m, block_n, slice_k, k,
                                a_density=a_density, w_density=w_density,
                                condense=condense)
    dense = float(mt * nt * s)
    return {"dense_steps": dense, "executed_steps": dense * frac,
            "executed_fraction": frac}


def _attn_layer_count(cfg: ModelConfig) -> int:
    n = sum(1 for p in range(cfg.period)
            if cfg.layer_kind(p) in ("attn", "cross")) * cfg.n_periods
    if cfg.is_encoder_decoder:
        n += cfg.n_encoder_layers + cfg.n_layers  # + cross-attn
    return n


def _mamba_layer_count(cfg: ModelConfig) -> int:
    return sum(1 for p in range(cfg.period)
               if cfg.layer_kind(p) == "mamba") * cfg.n_periods
