"""Whole Mamba2 and hybrid models against the JAX package: the JAX
``init_model(PRNGKey(0))`` parameters of ``mamba2-370m-smoke`` (tied
head, 2 Mamba layers) and ``jamba-1.5-large-398b-smoke`` (16 layers: two
periods of attention + 7 Mamba, MoE at odd positions) go through
``from_jax_params``; then, in float32:

* every port parameter equals its JAX leaf at ``pos{i % P}``, period
  ``i // P``; the tied model has no ``lm_head``;
* ``forward`` logits within 1e-4 (and the MoE layers' ``aux_loss``) in
  dense and dual; ``plan_weight_activities`` plans no Mamba block and no
  tied head, and equals the JAX plans elsewhere;
* ``generate`` emits the JAX ``generate``'s greedy tokens: mamba2-smoke
  in dual (the tied head planned per call), jamba-smoke cut to 8 layers
  (one period) in dual+kv on int8 caches (``rc.kv_quant``);
* the port's ``Engine`` emits the JAX ``Engine``'s tokens request for
  request on mamba2-smoke (the SSM state inserted into its slot);
* the engines name the 16-layer jamba's cache occupancy entries alike.

The JAX serve loop and engine run their XLA path
(``sparse_use_kernel=False``), jitted once for each case.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.models import transformer as jtfm
from repro.serving import engine as jeng
from repro.serving import serve_loop as jserve
import repro_torch.configs as tconfigs
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.models import convert
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.serving import engine as teng
from repro_torch.serving import serve_loop as tserve

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

MAMBA2, JAMBA = "mamba2-370m-smoke", "jamba-1.5-large-398b-smoke"
F32 = dict(act_dtype="float32")
DUAL = dict(sparse_mode="dual", sparse_use_kernel=True)
PROMPT, NEW = 9, 6


def _cfgs(name, n_layers=None, **knobs):
    """(JAX config, port config) with the same knobs (and depth)."""
    jc, tc = jconfigs.get_config(name), tconfigs.get_config(name)
    if n_layers:
        knobs["n_layers"] = n_layers
    return dataclasses.replace(jc, **knobs), dataclasses.replace(tc, **knobs)


@functools.lru_cache(maxsize=None)
def _numpy_params(name):
    p, _ = jtfm.init_model(jax.random.PRNGKey(0), jconfigs.get_config(name))
    return jax.tree_util.tree_map(lambda a: np.array(a), p)


@functools.lru_cache(maxsize=None)
def _weights(name, n_layers=None):
    """JAX parameters (as JAX arrays) and the port's model on them; a cut
    depth keeps the first ``n_layers / period`` periods of the smoke
    model's."""
    jcfg, tcfg = _cfgs(name, n_layers)
    p = dict(_numpy_params(name))
    p["layers"] = jax.tree_util.tree_map(lambda a: a[:jcfg.n_periods],
                                         p["layers"])
    model = convert.from_jax_params(p, tcfg, device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, p), model


def _tokens(name, b=2, s=PROMPT):
    vocab = tconfigs.get_config(name).vocab_size
    return np.random.default_rng(1).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name", [MAMBA2, JAMBA])
def test_from_jax_params_maps_periods(name):
    jparams, model = _weights(name)
    cfg = tconfigs.get_config(name)
    period = cfg.period
    assert (model.lm_head is None) == cfg.tie_embeddings
    assert ("lm_head" in jparams) != cfg.tie_embeddings
    tparams = dict(model.named_parameters())
    seen = set()
    for i, layer in enumerate(model.layers):
        stack = jparams["layers"][f"pos{i % period}"]
        assert layer.kind == cfg.layer_kind(i % period)
        assert (layer.ffn_key == "moe") == cfg.layer_is_moe(i % period)
        for path, leaf in jax.tree_util.tree_flatten_with_path(stack)[0]:
            keys = [k.key for k in path]
            tname = f"layers.{i}." + ".".join(keys)
            np.testing.assert_array_equal(tparams[tname].numpy(),
                                          np.asarray(leaf[i // period]),
                                          err_msg=tname)
            seen.add(tname)
    assert seen == {k for k in tparams if k.startswith("layers.")}
    if cfg.family == "ssm":
        assert all(layer.ffn is None and not hasattr(layer, "norm2")
                   for layer in model.layers)


@pytest.mark.parametrize("mode", ["dense", "dual"])
@pytest.mark.parametrize("name", [MAMBA2, JAMBA])
def test_forward_matches_jax(name, mode):
    jparams, model = _weights(name)
    jcfg, tcfg = _cfgs(name, **(DUAL if mode == "dual" else {}))
    tokens = _tokens(name)
    jout = jax.jit(lambda p, b: jtfm.forward(
        p, b, jcfg, mode="train", rc=JRunConfig(**F32)))(
            jparams, {"tokens": jnp.asarray(tokens)})
    tout = model({"tokens": torch.from_numpy(tokens).long()}, tcfg,
                 rc=TRunConfig(**F32))
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tout.aux_loss.item(), float(jout.aux_loss),
                               atol=1e-5, rtol=1e-5)
    assert (tout.aux_loss.item() > 0) == bool(tcfg.n_experts)


@pytest.mark.parametrize("name", [MAMBA2, JAMBA])
def test_plan_weight_activities_match_jax(name):
    jparams, model = _weights(name)
    jcfg, tcfg = _cfgs(name, **DUAL)
    jplans = jtfm.plan_weight_activities(jparams, jcfg)
    tplans = ttfm.plan_weight_activities(model, tcfg)
    assert ("lm_head" in tplans) == ("lm_head" in jplans) == \
        (not tcfg.tie_embeddings)
    for i, lp in enumerate(tplans["layers"]):
        jlp = jplans["layers"][f"pos{i % tcfg.period}"]
        assert set(lp) == set(jlp), i
        for blk, plans in lp.items():
            for key, act in plans.items():
                np.testing.assert_array_equal(
                    act.numpy(), np.asarray(jlp[blk][key][i // tcfg.period]))


def test_generate_mamba2_dual_matches_jax():
    """The tied head goes through the dispatch planned per call."""
    jparams, model = _weights(MAMBA2)
    jcfg, tcfg = _cfgs(MAMBA2, **DUAL)
    jcfg = dataclasses.replace(jcfg, sparse_use_kernel=False)
    tokens = _tokens(MAMBA2)
    jt = jserve.generate(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                         max_new_tokens=NEW, rc=JRunConfig(**F32))
    tt = tserve.generate(model, {"tokens": torch.from_numpy(tokens)}, tcfg,
                         max_new_tokens=NEW, rc=TRunConfig(**F32),
                         device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_generate_jamba_dual_kv_int8_matches_jax():
    """One period (8 layers) on int8 sparse-KV caches."""
    knobs = dict(DUAL, sparse_kv=True, sparse_block_t=8)
    jparams, model = _weights(JAMBA, 8)
    jcfg, tcfg = _cfgs(JAMBA, 8, **knobs)
    jcfg = dataclasses.replace(jcfg, sparse_use_kernel=False)
    tokens = _tokens(JAMBA)
    jt = jserve.generate(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                         max_new_tokens=NEW,
                         rc=JRunConfig(kv_quant=True, **F32))
    tt = tserve.generate(model, {"tokens": torch.from_numpy(tokens)}, tcfg,
                         max_new_tokens=NEW,
                         rc=TRunConfig(kv_quant=True, **F32), device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_engine_mamba2_matches_jax():
    """Three staggered requests on two slots (dense): each prefill's SSM
    state is inserted into a slot whose earlier state differs."""
    jparams, model = _weights(MAMBA2)
    jcfg, tcfg = _cfgs(MAMBA2)
    serve = dict(slots=2, capacity=32)
    je = jeng.Engine(jparams, jcfg, serve=JServeConfig(**serve),
                     rc=JRunConfig(**F32))
    te = teng.Engine(model, tcfg, serve=TServeConfig(**serve),
                     rc=TRunConfig(**F32), device="cpu")
    assert te.pool_stats() is None and je.pool_stats() is None
    assert all(isinstance(c, tssm.SSMState) for c in te.caches)
    prompts = [[5, 6, 7, 8, 9, 10], [11, 3, 9, 2, 4, 7], [8, 1, 2, 6, 4, 3]]
    done = {}
    for eng, mod in ((je, jeng), (te, teng)):
        out = []
        for uid, prompt in enumerate(prompts):
            eng.submit(mod.Request(uid=uid, prompt=list(prompt),
                                   max_new_tokens=6))
            out.extend(eng.step())
        out.extend(eng.run_to_completion())
        done[mod] = {r.uid: list(r.output) for r in out}
    assert done[teng] == done[jeng]
    assert all(len(t) == 6 for t in done[teng].values())
    assert te.stats()["pages_free"] == te.stats()["pages_total"]


def test_occupancy_names_match_jax_engine():
    """``kvcache.pos{i % P}.layer{i // P}``: the 16-layer jamba's two
    attention layers, no Mamba layer."""
    jcfg, tcfg = _cfgs(JAMBA, **DUAL, sparse_kv=True, sparse_block_t=8)
    jcaches = jtfm.init_caches(jcfg, 2, 32, sparse=True)
    tcaches = ttfm.init_caches(tcfg, 2, 32, sparse=True, device="cpu")
    assert [isinstance(c, tssm.SSMState) for c in tcaches] == [
        tcfg.layer_kind(i % 8) == "mamba" for i in range(16)]
    want = jeng.Engine._cache_occupancy_entries(
        types.SimpleNamespace(cfg=jcfg), jcaches)
    got = teng.Engine._cache_occupancy_entries(
        types.SimpleNamespace(cfg=tcfg), tcaches)
    assert [e["name"] for e in got] == [e["name"] for e in want] == [
        "kvcache.pos0.layer0", "kvcache.pos0.layer1"]
    for g, w in zip(got, want):
        assert g == {k: (float(v) if k.endswith("frac") else v)
                     for k, v in w.items()}
