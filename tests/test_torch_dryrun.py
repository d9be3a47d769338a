"""The port's dry run (``repro_torch.launch.dryrun``): cells on a fake
16×16 / 2×16×16 group at smoke size, the sharded step's collectives on a
fake group against real gloo ranks, the host reads the traced paths no
longer make, and the remaining functions (``as_planned``,
``mlp_activation_sparsity``) against the JAX package's."""
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import smoke_config as jax_smoke
from repro.models import mlp as jmlp
from repro.sparse import weights as jweights
from repro_torch import sparse as tsparse
from repro_torch.configs import smoke_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as shd
from repro_torch.launch import costmodel as cm
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshmod
from repro_torch.launch import roofline as rl
from repro_torch.models import mlp as tmlp
from repro_torch.testing import traced_step
from repro_torch.testing.sharded_moe import spawn

# the production shapes cut to smoke size (the cells' names kept)
SMOKE_SHAPES = {"train_4k": ShapeConfig("train_4k", "train", 16, 32),
                "prefill_32k": ShapeConfig("prefill_32k", "prefill", 16, 4),
                "decode_32k": ShapeConfig("decode_32k", "decode", 32, 4)}


@pytest.fixture
def smoke_cells(monkeypatch):
    """run_cell over smoke configs at SMOKE_SHAPES."""
    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    monkeypatch.setattr(dryrun, "SHAPES_BY_NAME", SMOKE_SHAPES)
    yield
    assert not dist.is_initialized()


CELLS = [("chatglm3-6b", "train_4k", False, RunConfig(microbatches=2)),
         ("chatglm3-6b", "prefill_32k", False, None),
         ("qwen3-moe-235b-a22b", "decode_32k", False, None),
         ("mixtral-8x7b", "train_4k", True, RunConfig(microbatches=2))]


@pytest.mark.parametrize("arch,shape,multi_pod,rc", CELLS,
                         ids=[f"{a}-{s}-{'2x16x16' if m else '16x16'}"
                              for a, s, m, _ in CELLS])
def test_run_cell(smoke_cells, tmp_path, arch, shape, multi_pod, rc):
    """A cell traces on a fake group of 256 / 512 ranks and leaves no
    group behind; its analytic keys are step_costs', its roofline terms
    theirs, its memory keys add up, and it writes its JSON."""
    r = dryrun.run_cell(arch, shape, multi_pod=multi_pod, rc_override=rc,
                        out_dir=str(tmp_path), verbose=False, device="cpu")
    assert not dist.is_initialized()
    assert not comm._GROUPS
    cfg, sh = smoke_config(arch), SMOKE_SHAPES[shape]
    rc = rc or dryrun.get_run_config(arch, shape)
    dp = 32 if multi_pod else 16
    ana = cm.step_costs(cfg, sh, rc, dp=dp, tp=16)
    assert {k[len("analytic_"):]: v for k, v in r.items()
            if k.startswith("analytic_")} == ana
    terms = rl.roofline(ana["flops_per_device"], ana["hbm_bytes_per_device"],
                        ana["coll_bytes_per_device"])
    assert {k: r[k] for k in terms} == terms
    assert r["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert r["traced_flops_per_device"] > 0
    assert r["traced_bytes_per_device"] > 0
    assert r["total_hbm_bytes"] == (
        r["argument_size_in_bytes"] + r["output_size_in_bytes"]
        + r["temp_size_in_bytes"] - r["alias_size_in_bytes"])
    assert r["fits_hbm"] == (r["total_hbm_bytes"] < rl.HBM_BYTES)
    assert r["trace_seconds"] > 0
    coll = r["traced_collectives"]
    if sh.kind == "train":
        # FSDP gathers the copies, the gradients are reduced
        assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
        assert r["placement"] == dryrun.TRAIN_PLACEMENT
        assert r["alias_size_in_bytes"] > 0     # masters and moments
    else:
        assert r["placement"] == dryrun.SERVE_PLACEMENT
    if cfg.n_experts and sh.kind != "train":
        assert coll["all-to-all"] > 0 or coll["all-reduce"] > 0
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    saved = json.loads((tmp_path / f"{arch}_{shape}_{r['mesh']}.json")
                       .read_text())
    assert saved["traced_flops_per_device"] == r["traced_flops_per_device"]


def test_train_cell_splits_rows_over_the_axes_that_divide_them(smoke_cells):
    """16 rows a microbatch on 2×16×16: split over data, repeated over pod
    (the JAX package's shape-aware fallback), where the step raised."""
    r = dryrun.run_cell("chatglm3-6b", "train_4k", multi_pod=True,
                        rc_override=RunConfig(microbatches=2),
                        verbose=False, device="cpu")
    one = dryrun.run_cell("chatglm3-6b", "train_4k", multi_pod=False,
                          rc_override=RunConfig(microbatches=2),
                          verbose=False, device="cpu")
    # the same rows a rank: the same products
    assert r["traced_flops_per_device"] == one["traced_flops_per_device"]
    # masters and moments split over twice the ranks
    assert r["argument_size_in_bytes"] < one["argument_size_in_bytes"]


def test_collectives_on_a_fake_group_equal_real_gloo_ranks():
    """The sharded smoke step on (2, 2): rank 0 of four real gloo ranks
    against rank 0 of a fake group of four, collective for collective
    (kind, dtype, shape), and the same FLOPs, bytes, arguments and
    peak."""
    outs = spawn([sys.executable, "-m", "repro_torch.testing.traced_step",
                  "--device", "cpu"], 4, timeout=240)
    real = [json.loads(line) for o in outs for line in o.splitlines()
            if line.startswith("{")]
    r0 = next(r for r in real if r["rank"] == 0)
    assert dryrun.join_fake_group(4)
    try:
        mesh = meshmod.make_mesh(traced_step.MESH)
        low = dryrun.lower(smoke_config(traced_step.ARCH), traced_step.RC,
                           traced_step.SHAPE, device="cpu", mesh=mesh,
                           rules=shd.make_rules("train"))
        trace, _ = dryrun.trace_lowered(low, mesh)
    finally:
        meshmod.destroy()

    def norm(records):
        return [(k, d, tuple(s)) for k, d, s in records]
    assert norm(trace.collectives) == norm(r0["collectives"])
    kinds = {k for k, _, _ in trace.collectives}
    assert {"all-gather", "all-reduce"} <= kinds
    assert (trace.flops, trace.bytes, trace.argument_bytes, trace.peak) == \
        (r0["flops"], r0["bytes"], r0["argument_bytes"], r0["peak"])
    # every rank issued the same collectives
    assert all(norm(r["collectives"]) == norm(r0["collectives"])
               for r in real)


def test_axis_groups_read_the_mesh_once():
    """axis_group and group_order under a fake-tensor mode: the mesh's rank
    layout comes from the cache its creation filled, not from a tensor
    op on mesh.mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    assert dryrun.join_fake_group(16)
    try:
        mesh = meshmod.make_mesh((4, 4))
        with FakeTensorMode():
            g = comm.axis_group(mesh, ("model",))
            assert comm.group_order(mesh, ("model",)) == [0, 1, 2, 3]
            assert comm.group_order(mesh, ("data",)) == [0, 1, 2, 3]
            # out of the mesh's order: rank data·4 + model is block
            # model·4 + data
            assert comm.group_order(mesh, ("model", "data")) == \
                [m * 4 + d for d in range(4) for m in range(4)]
        assert dist.get_process_group_ranks(g) == [0, 1, 2, 3]
        ranks, shape, names = comm.mesh_layout(mesh)
        assert ranks == tuple(range(16)) and shape == (4, 4)
        assert names == ("data", "model")
    finally:
        meshmod.destroy()


def test_sharded_step_reads_no_value_on_the_host():
    """The sharded train step's token shares are device tensors: the step
    runs under a fake mode, where a host read of a value raises."""
    assert dryrun.join_fake_group(4)
    try:
        mesh = meshmod.make_mesh((4, 1))
        low = dryrun.lower(smoke_config("mixtral-8x7b"), traced_step.RC,
                           traced_step.SHAPE, device="cpu", mesh=mesh,
                           rules=shd.make_rules("train"))
        trace, _ = dryrun.trace_lowered(low, mesh)
    finally:
        meshmod.destroy()
    assert trace.flops > 0


@pytest.mark.parametrize("slice_k", [8, 16])
def test_as_planned_matches_jax(slice_k):
    w = np.random.default_rng(0).normal(size=(64, 48)).astype(np.float32)
    w[8:24] = 0.0
    w[:, 5] = 0.0
    want = jweights.as_planned(jnp.asarray(w), slice_k=slice_k)
    got = tsparse.as_planned(torch.from_numpy(w), slice_k=slice_k)
    assert isinstance(got, tsparse.PlannedWeight)
    assert got.slice_k == want.slice_k
    np.testing.assert_array_equal(got.slice_act.numpy(),
                                  np.asarray(want.slice_act))
    assert tsparse.as_planned(got) is got


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "chatglm3-6b"])
def test_mlp_activation_sparsity_matches_jax(arch):
    cfg, jcfg = smoke_config(arch), jax_smoke(arch)
    rng = np.random.default_rng(1)
    d, f = cfg.d_model, cfg.d_ff
    params = {"w_up": rng.normal(size=(d, f)).astype(np.float32) * 0.2,
              "w_down": rng.normal(size=(f, d)).astype(np.float32) * 0.2}
    if cfg.mlp_type == "swiglu":
        params["w_gate"] = rng.normal(size=(d, f)).astype(np.float32) * 0.2
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    want = float(jmlp.mlp_activation_sparsity(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jcfg))
    got = tmlp.mlp_activation_sparsity(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - want) < 1e-6
    if cfg.mlp_type == "relu2":
        assert float(got) > 0.3        # half the pre-activations negative
