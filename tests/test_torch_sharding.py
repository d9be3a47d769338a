"""Sharding rules and specs: the port's ``distributed/sharding.py``,
``models/nn.py``'s logical-axis context, ``launch/mesh.py``'s shapes,
``plan.shard_plan``/``kplan_shardable`` and ``abstract_params``' logical
specs against the JAX package's, single-process (no group is joined).

A spec is compared as ``tuple(jax_spec)``: the port's ``PartitionSpec``
is a tuple of the same entries.  The cases of ``tests/test_sharding.py``
come first (dedup, the divisibility drop, multi-pod tuple axes, the rules
covering every logical axis, the cache-axes tree), then the same
functions against JAX's on random and exhaustive inputs.
"""
import dataclasses
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.models import nn as jnn
from repro.sparse import plan as jpln
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tshd
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.models import nn as tnn
from repro_torch.models import transformer as ttfm
from repro_torch.models.convert import param_axes
from repro_torch.sparse import plan as tpln
from repro_torch.training import optimizer as topt

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

ARCHS = jconfigs.list_archs()
# one smoke config per family
FAMILIES = ("nemotron-4-340b", "qwen3-moe-235b-a22b", "mamba2-370m",
            "jamba-1.5-large-398b", "whisper-base", "llama-3.2-vision-90b")
RULE_SETS = {
    "train": dict(kind="train"),
    "decode_2d": dict(kind="decode", decode_2d=True),
}


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _jax_specs(cfg):
    """{JAX leaf name (dotted): logical axes} of ``abstract_params``."""
    _, specs = jzoo.abstract_params(cfg)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=_is_axes)[0]
    return {".".join(str(k.key) for k in path): ax for path, ax in flat}


def _port_vs_jax_leaf(tname, period):
    """(JAX leaf name, whether the port's axes lose its stacking axis)."""
    leaf, j = topt.stacked_leaf(tname, period)
    return leaf, j is not None


# -- the cases of tests/test_sharding.py ---------------------------------

def test_spec_dedup():
    rules = {"batch": "data", "embed": "data", "mlp": "model"}
    spec = tshd.spec_from_axes(("batch", "seq", "embed"), rules)
    assert spec == ("data", None, None)
    assert spec == tuple(jshd.spec_from_axes(("batch", "seq", "embed"),
                                             rules))


def test_spec_divisibility_drop():
    rules = {"kv_heads": "model", "embed": "data"}
    sizes = {"data": 16, "model": 16}
    spec = tshd.spec_from_axes(("embed", "kv_heads"), rules,
                               shape=(64, 2), axis_sizes=sizes)
    assert spec == ("data", None)
    spec2 = tshd.spec_from_axes(("embed", "kv_heads"), rules,
                                shape=(64, 32), axis_sizes=sizes)
    assert spec2 == ("data", "model")


def test_multi_pod_tuple_axes():
    rules = tshd.make_rules("train", multi_pod=True)
    assert tshd.spec_from_axes(("batch", None), rules) == (
        ("pod", "data"), None)


@pytest.mark.parametrize("kind", [
    dict(kind="train"), dict(kind="prefill"), dict(kind="decode"),
    dict(kind="decode", decode_2d=True), dict(kind="long"),
    dict(kind="train", multi_pod=True),
    dict(kind="decode", multi_pod=True, decode_2d=True)])
def test_make_rules_match_jax(kind):
    kw = dict(kind)
    k = kw.pop("kind")
    assert tshd.make_rules(k, **kw) == jshd.make_rules(k, **kw)


def test_make_rules_rejects_unknown():
    with pytest.raises(ValueError):
        tshd.make_rules("serve")


def test_rules_cover_all_logical_axes_used_by_models():
    rules = tshd.make_rules("train")
    for arch in ["jamba-1.5-large-398b", "whisper-base",
                 "llama-3.2-vision-90b", "qwen3-moe-235b-a22b"]:
        _, specs = tzoo.abstract_params(tconfigs.smoke_config(arch))
        for axes in specs.values():
            assert _is_axes(axes)
            for a in axes:
                assert a is None or a in rules, (arch, a)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_tree_matches_cache_structure(arch):
    """One entry per decoder layer, each field's axes one per dimension
    of the port's cache (with ``quantized`` scales; a VLM's cross caches
    have none) and equal to the JAX tree's position entry without
    ``"layers"``; the ints ``pos``/``window`` take ``()``."""
    cfg = tconfigs.smoke_config(arch)
    caches = ttfm.init_caches(cfg, 2, 16, quantized=True, device="meta")
    axes = tshd.cache_logical_axes(cfg)
    jaxes = jshd.cache_logical_axes(jconfigs.smoke_config(arch))
    assert len(axes) == len(caches) == cfg.n_layers
    for i, (c, a) in enumerate(zip(caches, axes)):
        assert type(a) is type(c)
        pos = jaxes[f"pos{i % cfg.period}"]
        pairs = ([(c.kv, a.kv, pos["kv"]), (c.cross_kv, a.cross_kv,
                                             pos["cross_kv"])]
                 if cfg.is_encoder_decoder else
                 [(c, a, pos["ssm"] if "ssm" in pos else pos["kv"])])
        for cache, ax, jax_ax in pairs:
            for field in dataclasses.fields(cache) if \
                    dataclasses.is_dataclass(cache) else cache._fields:
                name = getattr(field, "name", field)
                leaf, got = getattr(cache, name), getattr(ax, name)
                if isinstance(leaf, int):
                    assert got == (), name
                    continue
                # a tensor, or the scales an unquantised cache lacks
                assert got == getattr(jax_ax, name)[1:], name
                if leaf is not None:
                    assert len(got) == leaf.ndim, (name, got)


def test_shard_act_is_identity():
    x = torch.ones(4, 4)
    assert tnn.shard_act(x, "batch", "embed") is x
    with tnn.axis_rules(tshd.make_rules("train"),
                        axis_sizes={"data": 2, "model": 2}):
        assert tnn.shard_act(x, "batch", "embed") is x
        with tnn.manual_axes():
            assert tnn.shard_act(x, "batch", "embed") is x


# -- the logical-axis context against JAX's --------------------------------

@pytest.mark.parametrize("sizes", [None, {"data": 2, "model": 4},
                                   {"pod": 2, "data": 4, "model": 8}])
def test_axis_context_matches_jax(sizes):
    rules = tshd.make_rules("train", multi_pod=True)
    cases = [(("batch", "seq", "embed"), (8, 3, 64)),
             (("embed", "kv_heads"), (64, 2)),
             (("experts", "embed", "mlp"), (8, 32, 12)),
             (("vocab", "embed"), (6, 64))]
    with tnn.axis_rules(rules, axis_sizes=sizes), \
            jnn.axis_rules(rules, axis_sizes=sizes):
        assert tnn.current_rules() == jnn.current_rules()
        assert tnn.current_mesh() is None
        for axes, shape in cases:
            for sh in (None, shape):
                assert tnn.resolve_spec(axes, sh) == tuple(
                    jnn.resolve_spec(axes, sh)), (axes, sh)
            for logical in ("batch", "mlp", "experts", "seq", "kv_heads"):
                for size in (1, 2, 6, 8, 16, 64):
                    assert tnn.dim_shardable(size, logical) == \
                        jnn.dim_shardable(size, logical)
        for name in ("data", "model", ("pod", "data"), None, "nope"):
            assert tnn.mesh_axis_size(name) == jnn.mesh_axis_size(name)
    assert tnn.current_rules() is None and tnn.resolve_spec(("batch",)) is \
        None


_LOGICAL = ("batch", "embed", "mlp", "heads", "experts", "vocab", "seq",
            "kv_heads")
_MESH = ("pod", "data", "model")
_rule = st.one_of(st.none(), st.sampled_from(_MESH),
                  st.lists(st.sampled_from(_MESH), min_size=1, max_size=3,
                           unique=True).map(tuple))


@settings(max_examples=150, deadline=None)
@given(axes=st.lists(st.one_of(st.none(), st.sampled_from(_LOGICAL)),
                     min_size=1, max_size=5),
       rules=st.dictionaries(st.sampled_from(_LOGICAL), _rule),
       dims=st.lists(st.integers(1, 64), min_size=5, max_size=5),
       sizes=st.fixed_dictionaries({a: st.integers(1, 8) for a in _MESH}),
       shaped=st.booleans())
def test_spec_from_axes_matches_jax(axes, rules, dims, sizes, shaped):
    shape = dims[:len(axes)] if shaped else None
    kw = dict(shape=shape, axis_sizes=sizes if shaped else None)
    got = tshd.spec_from_axes(tuple(axes), rules, **kw)
    want = jshd.spec_from_axes(tuple(axes), rules, **kw)
    assert got == tuple(want)


@settings(max_examples=150, deadline=None)
@given(parts=st.lists(st.sampled_from(_MESH), max_size=3, unique=True),
       dim=st.integers(1, 256),
       sizes=st.fixed_dictionaries({a: st.integers(1, 16) for a in _MESH}))
def test_best_divisible_matches_jax(parts, dim, sizes):
    got = tshd._best_divisible(tuple(parts), dim, sizes)
    assert got == tuple(jshd._best_divisible(tuple(parts), dim, sizes))
    assert got == tuple(jnn._best_divisible(tuple(parts), dim, sizes))
    assert tnn._best_divisible is tshd._best_divisible


# -- plan, input and optimizer specs ----------------------------------------

@pytest.mark.parametrize("ep_mode", [True, False])
@pytest.mark.parametrize("k_shardable", [True, False])
@pytest.mark.parametrize("axis", ["model", ("model", "data")])
def test_plan_specs_match_jax(ep_mode, k_shardable, axis):
    got = tshd.moe_plan_specs(axis, ep_mode=ep_mode,
                              down_k_shardable=k_shardable)
    want = jshd.moe_plan_specs(axis, ep_mode=ep_mode,
                               down_k_shardable=k_shardable)
    assert {k: tuple(v) for k, v in want.items()} == got
    for key in ("w_up", "w_gate", "w_down"):
        assert tshd.plan_spec_from_site(
            tmoe.moe_site(key), axis, ep_mode=ep_mode,
            k_shardable=k_shardable) == tuple(jshd.plan_spec_from_site(
                jmoe.moe_site(key), axis, ep_mode=ep_mode,
                k_shardable=k_shardable))
    assert tmoe.moe_site("w_down").axes == jmoe.moe_site("w_down").axes


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "whisper-base",
                                  "llama-3.2-vision-90b"])
@pytest.mark.parametrize("rules", list(RULE_SETS))
def test_input_pspecs_match_jax(arch, rules):
    kw = dict(RULE_SETS[rules])
    r = tshd.make_rules(kw.pop("kind"), **kw)
    tcfg, jcfg = tconfigs.smoke_config(arch), jconfigs.smoke_config(arch)
    for shape in tconfigs.SHAPES[:3]:
        got = tshd.input_pspecs(tzoo.input_specs(tcfg, shape), r)
        want = jshd.input_pspecs(jzoo.input_specs(
            jcfg, jconfigs.SHAPES_BY_NAME[shape.name]), r)
        assert got == {k: tuple(v) for k, v in want.items()}


def test_opt_state_pspecs_match_jax():
    specs = {"embed": tshd.PartitionSpec("model", "data"),
             "layers.0.attn.wq": tshd.PartitionSpec("data", "model", None)}
    got = tshd.opt_state_pspecs(specs)
    want = jshd.opt_state_pspecs(specs)
    assert got["m"] == want["m"] and got["v"] == want["v"]
    assert got["step"] == tuple(want["step"]) == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_specs_match_jax(arch):
    """Every parameter's logical axes equal its JAX leaf's, through the
    name map, without the stacking axis."""
    tcfg = tconfigs.smoke_config(arch)
    model, specs = tzoo.abstract_params(tcfg)
    jspecs = _jax_specs(jconfigs.smoke_config(arch))
    assert set(specs) == {n for n, _ in model.named_parameters()}
    seen = set()
    for name, p in model.named_parameters():
        leaf, stacked = _port_vs_jax_leaf(name, tcfg.period)
        want = jspecs[leaf]
        if stacked:
            assert want[0] == "layers"
            want = want[1:]
        assert specs[name] == want == param_axes(name), name
        assert len(want) == p.ndim, name
        seen.add(leaf)
    assert seen == set(jspecs)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("rules", list(RULE_SETS))
def test_tree_pspecs_match_jax(arch, rules):
    kw = dict(RULE_SETS[rules])
    r = tshd.make_rules(kw.pop("kind"), **kw)
    tcfg, jcfg = tconfigs.smoke_config(arch), jconfigs.smoke_config(arch)
    model, specs = tzoo.abstract_params(tcfg)
    got = tshd.tree_pspecs(specs, r)
    _, jspecs = jzoo.abstract_params(jcfg)
    want = jshd.tree_pspecs(jspecs, r)
    flat = {".".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    for name, spec in got.items():
        leaf, stacked = _port_vs_jax_leaf(name, tcfg.period)
        w = tuple(flat[leaf])
        assert spec == (w[1:] if stacked else w), name
    # the shape-aware form over a 2 x 4 mesh, per leaf
    sizes = {"data": 2, "model": 4}
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 4))
    shaped = tshd.tree_pspecs_shaped(
        specs, {n: p for n, p in model.named_parameters()}, r, mesh)
    for name, p in model.named_parameters():
        assert shaped[name] == tshd.spec_from_axes(specs[name], r, p.shape,
                                                   sizes)


def test_tree_pspecs_keep_lists_and_placements():
    rules = {"batch": "data", "embed": ("data", "model")}
    tree = {"a": [("batch", None), ("embed",)], "b": ("embed", "batch")}
    got = tshd.tree_pspecs(tree, rules)
    assert got == {"a": [("data", None), (("data", "model"),)],
                   "b": (("data", "model"), None)}
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    from torch.distributed.tensor import Replicate, Shard
    assert tshd.tree_shardings(mesh, got) == {
        "a": [[Shard(0), Replicate()], [Shard(0), Shard(0)]],
        "b": [Shard(0), Shard(0)]}
    assert tshd.placements(mesh, tshd.PartitionSpec(None, "model")) == [
        Replicate(), Shard(1)]


class _FakeMesh:
    """A (2, 3) ("data", "model") mesh seen from one coordinate."""

    mesh_dim_names = ("data", "model")
    shape = (2, 3)

    def __init__(self, coord):
        self.coord = coord

    def get_coordinate(self):
        return list(self.coord)


@pytest.mark.parametrize("spec", [("data", None), (None, "model"),
                                  ("model", "data"),
                                  (("data", "model"), None),
                                  (None, ("model", "data"))])
def test_local_slice_blocks_tile_the_tensor(spec):
    """Every coordinate's block, put back at its range, rebuilds the
    whole tensor once."""
    t = torch.arange(12 * 6).reshape(12, 6)
    hits = torch.zeros_like(t)
    for coord in itertools.product(range(2), range(3)):
        m = _FakeMesh(coord)
        block = tshd.local_slice(t, spec, m)
        (r0, r1), (c0, c1) = (tshd.block_range(t.shape[d], e, m)
                              for d, e in enumerate(spec))
        assert torch.equal(block, t[r0:r1, c0:c1])
        hits[r0:r1, c0:c1] += 1
    n = 1
    for e in spec:
        n *= 1 if e is None else 2 if e == "data" else 3 if e == "model" \
            else 6
    assert (hits == 6 // n).all()
    with pytest.raises(ValueError):
        tshd.local_slice(torch.zeros(5, 5), spec, _FakeMesh((0, 0)))


@pytest.mark.parametrize("k", [8, 16, 24, 32, 64, 96, 100, 128, 256, 512])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_kplan_shardable_matches_jax(k, n_shards):
    for sk in (8, 16, 32, 128):
        assert tpln.kplan_shardable(k, n_shards, sk) == \
            jpln.kplan_shardable(k, n_shards, sk)


@pytest.mark.parametrize("axis", [0, 1])
def test_shard_plan_matches_jax(axis):
    """A fiber range of a front-packed grouped plan equals JAX's and the
    plan of the sliced activity."""
    rng = np.random.default_rng(0)
    col = rng.random((6, 3, 5)) < 0.5               # (E, Mt, S)
    row = rng.random((6, 5, 4)) < 0.5               # (E, S, Nt)
    ks, counts = tpln.plan_from_activity(torch.from_numpy(col),
                                         torch.from_numpy(row))
    jks, jcounts = jpln.plan_grouped_activity(jnp.asarray(col),
                                              jnp.asarray(row))
    for start, size in ((0, 2), (2, 1), (1, 2)):
        a, b = tpln.shard_plan(ks, counts, start, size, axis=axis)
        ja, jb = jpln.shard_plan(jks, jcounts, start, size, axis=axis)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        if axis == 0:
            la, lb = tpln.plan_from_activity(
                torch.from_numpy(col[start:start + size]),
                torch.from_numpy(row[start:start + size]))
            assert torch.equal(a, la) and torch.equal(b, lb)


@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16), (1, 4), (8,)])
def test_mesh_config_n_devices(shape):
    names = ("pod", "data", "model")[-len(shape):]
    got = tconfigs.MeshConfig(shape=shape, axes=names)
    want = jconfigs.MeshConfig(shape=shape, axes=names)
    assert got.n_devices == want.n_devices == int(np.prod(shape))
    assert tconfigs.MeshConfig() == tconfigs.MeshConfig((16, 16),
                                                        ("data", "model"))
    assert tconfigs.MeshConfig().n_devices == \
        jconfigs.MeshConfig().n_devices == 256


def test_production_mesh_needs_its_world():
    """Without a group the host mesh has one rank, and the production
    meshes refuse a group of another size (checked in a fresh process:
    a mesh joins this process to a one-rank group)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = (
        "from repro_torch.launch import mesh\n"
        "m = mesh.make_host_mesh()\n"
        "assert tuple(m.shape) == (1, 1), m.shape\n"
        "assert m.mesh_dim_names == ('data', 'model')\n"
        "for mp in (False, True):\n"
        "    try:\n"
        "        mesh.make_production_mesh(multi_pod=mp)\n"
        "        raise SystemExit('no error')\n"
        "    except ValueError as e:\n"
        "        assert 'ranks' in str(e), e\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
