"""The port's analytic cost model and roofline (``repro_torch.launch.
costmodel``/``roofline``) against the JAX package's: ``step_costs`` and
``_param_counts`` bit for bit, the counterparts of ``tests/test_costmodel.py``
and ``tests/test_roofline.py``, and :class:`StepTrace`'s counts of a traced
step against a real CPU run and XLA's ``cost_analysis``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_config
from repro.configs import list_archs as jax_archs
from repro.configs import runnable_shapes as jax_shapes
from repro.configs import smoke_config as jax_smoke
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch import costmodel as jcm
from repro_torch.configs import get_config, get_run_config, list_archs
from repro_torch.configs import smoke_config
from repro_torch.configs.base import RunConfig, SHAPES_BY_NAME, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import costmodel as cm
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.models import model_zoo
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import make_train_step

MESHES = [(16, 16), (32, 16), (1, 1)]
VARIANTS = [{}, dict(remat="none"), dict(remat="dots"),
            dict(microbatches=4), dict(microbatches=16),
            dict(decode_2d=True), dict(kv_quant=True),
            dict(optimizer="adamw_bf16"), dict(optimizer="adafactor"),
            dict(accum_dtype="bfloat16")]


def _port_rc(rc: RunConfig, kw: dict) -> RunConfig:
    return dataclasses.replace(rc, **{k: v for k, v in kw.items()
                                      if k != "decode_2d"})


def _jax_rc(rc: RunConfig, kw: dict) -> JaxRunConfig:
    fields = {f.name for f in dataclasses.fields(JaxRunConfig)}
    base = {k: v for k, v in dataclasses.asdict(rc).items() if k in fields}
    return JaxRunConfig(**{**base, **kw})


def test_port_lists_the_same_archs():
    assert list_archs() == jax_archs()


@pytest.mark.parametrize("arch", jax_archs())
def test_step_costs_bit_equal(arch):
    """Every runnable shape, three meshes, the run table's config and its
    variants: each key bit for bit, and the parameter counts."""
    assert cm._param_counts(get_config(arch)) == \
        jcm._param_counts(jax_config(arch))
    assert cm._param_counts(smoke_config(arch)) == \
        jcm._param_counts(jax_smoke(arch))
    assert cm._attn_layer_count(get_config(arch)) == \
        jcm._attn_layer_count(jax_config(arch))
    assert cm._mamba_layer_count(get_config(arch)) == \
        jcm._mamba_layer_count(jax_config(arch))
    n = 0
    for s in jax_shapes(arch):
        rc = get_run_config(arch, s.name)
        for kw in VARIANTS:
            for dp, tp in MESHES:
                want = jcm.step_costs(jax_config(arch), s, _jax_rc(rc, kw),
                                      dp=dp, tp=tp)
                got = cm.step_costs(get_config(arch),
                                    SHAPES_BY_NAME[s.name], _port_rc(rc, kw),
                                    dp=dp, tp=tp,
                                    decode_2d=kw.get("decode_2d", False))
                assert got == want, (s.name, kw, dp, tp)
                n += 1
    assert n == len(jax_shapes(arch)) * len(VARIANTS) * len(MESHES)


# ---------------------------------------------------------------------------
# counterparts of tests/test_costmodel.py
# ---------------------------------------------------------------------------

def test_best_divisible_prefers_largest_subset():
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert shd._best_divisible(("pod", "data"), 16, sizes) == ("data",)
    assert shd._best_divisible(("pod", "data"), 64, sizes) == \
        ("pod", "data")
    assert shd._best_divisible(("pod", "data"), 2, sizes) == ("pod",)
    assert shd._best_divisible(("pod", "data"), 7, sizes) == ()


def test_spec_fallback_multi_pod_batch16():
    rules = shd.make_rules("train", multi_pod=True)
    sizes = {"pod": 2, "data": 16, "model": 16}
    spec = shd.spec_from_axes(("batch", None), rules, shape=(16, 8),
                              axis_sizes=sizes)
    assert spec == shd.PartitionSpec("data", None)


def test_decode_2d_rules():
    rules = shd.make_rules("decode", decode_2d=True)
    assert rules["mlp"] == ("model", "data")
    assert rules["embed"] is None
    assert rules["kv_batch"] == "data"
    assert shd.make_rules("decode")["embed"] == "data"


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "qwen1.5-110b"])
def test_costmodel_decode_2d_cuts_collectives(arch):
    cfg, shape = get_config(arch), SHAPES_BY_NAME["decode_32k"]
    rc = get_run_config(arch, "decode_32k")
    base = cm.step_costs(cfg, shape, rc, dp=16, tp=16)
    two = cm.step_costs(cfg, shape, rc, dp=16, tp=16, decode_2d=True)
    assert two["coll_bytes_per_device"] < 0.2 * base["coll_bytes_per_device"]


def test_costmodel_train_collective_scales_with_microbatches():
    cfg, shape = get_config("qwen3-moe-235b-a22b"), SHAPES_BY_NAME["train_4k"]
    c16 = cm.step_costs(cfg, shape, RunConfig(microbatches=16), dp=16,
                        tp=16)
    c4 = cm.step_costs(cfg, shape, RunConfig(microbatches=4), dp=16, tp=16)
    ratio = c16["coll_bytes_per_device"] / c4["coll_bytes_per_device"]
    assert 2.5 < ratio < 4.5
    assert c16["flops_per_device"] == c4["flops_per_device"]


def test_costmodel_remat_factor():
    cfg, shape = get_config("yi-34b"), SHAPES_BY_NAME["train_4k"]
    full = cm.step_costs(cfg, shape, RunConfig(remat="full"), dp=16, tp=16)
    none = cm.step_costs(cfg, shape, RunConfig(remat="none"), dp=16, tp=16)
    assert abs(full["flops_per_device"] / none["flops_per_device"]
               - 4.0 / 3.0) < 1e-6


def test_model_flops_moe_uses_active():
    out = cm.step_costs(get_config("mixtral-8x7b"),
                        SHAPES_BY_NAME["prefill_32k"], RunConfig(), dp=16,
                        tp=16)
    assert out["params_active"] < 0.4 * out["params_total"]


# ---------------------------------------------------------------------------
# counterparts of tests/test_roofline.py
# ---------------------------------------------------------------------------

def test_roofline_terms_and_bottleneck():
    t = rl.roofline(rl.PEAK_FLOPS, rl.HBM_BW, 0.0)   # 1 s compute, 1 s HBM
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert abs(t["memory_s"] - 1.0) < 1e-9
    t2 = rl.roofline(1e12, 1e9, rl.LINK_BW)
    assert t2["bottleneck"] == "collective_s"


def test_model_flops_definition():
    assert rl.model_flops(1e9, 100, "train") == 6e11
    assert rl.model_flops(1e9, 100, "decode") == 2e11


def test_costmodel_moe_counts_active_only():
    moe = smoke_config("mixtral-8x7b")
    pc = cm._param_counts(moe)
    assert pc["active"] < pc["total"]
    frac = (pc["active"] - (pc["total"] - pc["moe"])) / max(pc["moe"], 1)
    assert abs(frac - moe.n_experts_active / moe.n_experts) < 1e-6
    pcd = cm._param_counts(smoke_config("chatglm3-6b"))
    assert pcd["active"] == pcd["total"]


def test_collective_bytes_sums_records_with_ring_factors():
    recs = [("all-gather", "torch.bfloat16", (4, 8)),
            ("all-reduce", "torch.float32", (10,)),
            ("all-reduce", "torch.float32", ()),
            ("all-to-all", "torch.int8", (3, 5))]
    out = rl.collective_bytes(recs)
    assert out["all-gather"] == 64.0
    assert out["all-reduce"] == 2.0 * (40 + 4)
    assert out["all-to-all"] == 15.0
    assert out["reduce-scatter"] == out["collective-permute"] == 0.0
    assert out["total"] == 64.0 + 88.0 + 15.0
    assert rl._shape_bytes("torch.bfloat16", (3, 7)) == 42


# ---------------------------------------------------------------------------
# the traced step (StepTrace) against a real run and against XLA
# ---------------------------------------------------------------------------

B, S = 4, 32


def _one_device_trace(rc: RunConfig, *, fake: bool, layers: int = 0,
                      batch: int = B):
    """StepTrace of chatglm3-6b-smoke's one-device train step on B x S
    tokens (zeros), real CPU tensors or fake ones."""
    cfg = smoke_config("chatglm3-6b")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = ShapeConfig("tiny", "train", S, batch)
    if fake:
        low = dryrun.lower(cfg, rc, shape, device="cpu")
        trace, _ = dryrun.trace_lowered(low)
        return trace, low.args
    model = model_zoo.build_model(cfg, 0, device="cpu")
    data = {k: torch.zeros((batch, S), dtype=torch.int32)
            for k in ("tokens", "labels")}
    parts = dryrun.train_parts(cfg, rc, model, data)
    trace, _ = dryrun.trace_step(*parts)
    return trace, parts[1]


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_fake_trace_equals_real_cpu_run(remat):
    """The fake trace's FLOPs, bytes, peak and argument bytes equal the
    same step's on real CPU tensors; the FLOPs equal FlopCounterMode's of
    the real step (88,080,384 at remat none); the arguments are the
    parameters, the two moments and the batch."""
    rc = RunConfig(microbatches=1, remat=remat)
    real, args = _one_device_trace(rc, fake=False)
    fake, _ = _one_device_trace(rc, fake=True)
    assert (fake.flops, fake.bytes, fake.peak, fake.argument_bytes) == \
        (real.flops, real.bytes, real.peak, real.argument_bytes)
    model, ostate, _, batch = args
    assert real.argument_bytes == _nbytes(
        list(model.parameters()) + list(ostate.m.values())
        + list(ostate.v.values()) + [ostate.step] + list(batch.values()))
    cfg = smoke_config("chatglm3-6b")
    m2 = model_zoo.build_model(cfg, 0, device="cpu")
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg, rc)(
            m2, opt.init_opt_state(dict(m2.named_parameters()), rc), None,
            {k: torch.zeros((B, S), dtype=torch.int32)
             for k in ("tokens", "labels")})
    assert fc.get_total_flops() == real.flops
    if remat == "none":
        assert real.flops == 88_080_384
    mem = rl.memory_summary(fake)
    assert mem["total_hbm_bytes"] == fake.peak
    assert mem["alias_size_in_bytes"] > 0.9 * mem["argument_size_in_bytes"]


def test_traced_count_scales_with_layers_and_microbatches():
    """Where XLA's cost_analysis counts a loop's body once (the JAX
    test_cost_analysis_counts_while_once), an eager trace counts every
    layer and microbatch: the products grow by the layers' share with
    depth and equal with microbatches (the same tokens)."""
    rc1 = RunConfig(microbatches=1, remat="none")
    one, _ = _one_device_trace(rc1, fake=True, layers=1)
    two, _ = _one_device_trace(rc1, fake=True, layers=2)
    four, _ = _one_device_trace(rc1, fake=True, layers=4)
    assert four.flops - two.flops == 2 * (two.flops - one.flops) > 0
    mb2, _ = _one_device_trace(RunConfig(microbatches=2, remat="none"),
                               fake=True)
    assert mb2.flops == two.flops
    assert mb2.bytes > two.bytes


def test_traced_flops_against_xla_and_analytic():
    """The unrolled smoke step (tests/test_roofline.py's setup): the traced
    FLOPs within [0.80, 1.00] of XLA's cost_analysis (which also counts
    elementwise work), the analytic count within 0.4-2.5x of the traced."""
    from repro.models import transformer as jtfm
    from repro.training import optimizer as jopt
    from repro.training.train_loop import make_train_step as jax_step
    jcfg = jax_smoke("chatglm3-6b")
    jrc = JaxRunConfig(microbatches=1, remat="none", scan_unroll=True)
    params = jax.eval_shape(
        lambda: jtfm.init_model(jax.random.PRNGKey(0), jcfg)[0])
    ostate = jax.eval_shape(lambda p: jopt.init_opt_state(p, jrc), params)
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    ca = jax.jit(jax_step(jcfg, jrc)).lower(params, ostate, None,
                                            batch).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    xla = float(ca.get("flops", 0))
    rc = RunConfig(microbatches=1, remat="none")
    traced, _ = _one_device_trace(rc, fake=True)
    assert 0.80 <= traced.flops / xla <= 1.00, (traced.flops, xla)
    ana = cm.step_costs(smoke_config("chatglm3-6b"),
                        ShapeConfig("tiny", "train", S, B), rc, dp=1, tp=1)
    assert 0.4 < ana["flops_per_device"] / traced.flops < 2.5
    assert np.isclose(ana["flops_per_device"], 110_100_480)
