"""The dense GQA families against the JAX package: ``yi-34b`` (56 heads
over 8 KV heads), ``qwen1.5-110b`` (qkv bias) and ``chatglm3-6b`` (qkv
bias, the ``"2d"`` RoPE that rotates half of each head).

* the configs, full and smoke, field for field, and the run table:
  ``get_run_config`` for every ported arch and every shape, the
  registered overrides themselves, ``list_archs`` and
  ``runnable_shapes``;
* ``from_jax_params`` carries ``bq``/``bk``/``bv`` across;
* ``apply_rope`` in the ``"2d"`` and ``"half"`` styles, shared and per-row
  positions;
* float32 forward logits within 1e-4 for the three smoke models (random
  qkv biases: JAX starts them at zero), in dense and dual modes;
* ``generate`` on yi-34b-smoke and chatglm3-6b-smoke in dual mode, and
  the ``Engine`` on chatglm3-6b-smoke (dense) and yi-34b-smoke (dual,
  sparse KV), greedy tokens identical.

The JAX serve loop and engine run their XLA path
(``sparse_use_kernel=False``), as in ``test_torch_engine.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.serving import engine as jeng
from repro.serving import serve_loop as jserve
import repro_torch.configs as tconfigs
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.models import attention as tattn
from repro_torch.models import convert
from repro_torch.serving import engine as teng
from repro_torch.serving import serve_loop as tserve

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

FAMILIES = ("yi-34b", "qwen1.5-110b", "chatglm3-6b")
F32 = dict(act_dtype="float32")
DUAL = dict(sparse_mode="dual", sparse_use_kernel=True)
PROMPT, NEW = 9, 6


# ---------------------------------------------------------------------------
# configs and the run table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [*FAMILIES, *(f"{a}-smoke" for a in FAMILIES)])
def test_configs_match_jax(name):
    """Every field the port has equals the JAX config's; every field it
    lacks is at the JAX default, so nothing of the model is lost."""
    tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
    tnames = {f.name for f in dataclasses.fields(tcfg)}
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), \
            field.name
    for field in dataclasses.fields(jcfg):
        if field.name not in tnames:
            assert getattr(jcfg, field.name) == field.default, field.name
    assert (tcfg.hd, tcfg.period, tcfg.n_periods) == (jcfg.hd, jcfg.period,
                                                       jcfg.n_periods)
    assert tcfg.family == "dense" and not tcfg.n_experts
    assert tcfg.qkv_bias == (not name.startswith("yi"))


def test_run_table_matches_jax():
    """Every ported arch (and smoke variant) at every shape: each port
    field equals the JAX one, every JAX override names a port field, and
    the registered overrides are the same."""
    tfields = {f.name for f in dataclasses.fields(TRunConfig)}
    assert [s for s in tconfigs.SHAPES] == [
        tconfigs.ShapeConfig(*dataclasses.astuple(s))
        for s in jconfigs.SHAPES]
    assert tconfigs.SHAPES_BY_NAME == {
        k: tconfigs.ShapeConfig(*dataclasses.astuple(s))
        for k, s in jconfigs.SHAPES_BY_NAME.items()}
    # list_archs loads both registries
    ported = tconfigs.list_archs()
    assert set(ported) <= set(jconfigs.list_archs())
    names = [*ported, *(f"{a}-smoke" for a in ported)]
    for name in names:
        assert tconfigs._RUN_OVERRIDES[name] == jconfigs._RUN_OVERRIDES[name]
        for shape in jconfigs.SHAPES:
            trc = tconfigs.get_run_config(name, shape.name)
            jrc = jconfigs.get_run_config(name, shape.name)
            for f in tfields:
                assert getattr(trc, f) == getattr(jrc, f), (name, shape, f)
            assert set(jconfigs._RUN_OVERRIDES[name].get(shape.name, {})
                       ) <= tfields
    assert tconfigs.get_run_config("qwen1.5-110b", "decode_32k").kv_quant
    assert tconfigs.get_run_config("qwen1.5-110b",
                                   "decode_32k").attn_chunk == 2048


def test_list_archs_and_runnable_shapes():
    ported = tconfigs.list_archs()
    assert ported == [a for a in jconfigs.list_archs() if a in ported]
    assert set(FAMILIES) <= set(ported)
    for arch in ported:
        got = [s.name for s in tconfigs.runnable_shapes(arch)]
        assert got == [s.name for s in jconfigs.runnable_shapes(arch)], arch
        assert ("long_500k" in got) == tconfigs.get_config(arch).subquadratic


# ---------------------------------------------------------------------------
# weights, RoPE, forward
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _weights(arch):
    """JAX ``init_model`` parameters of the smoke model, qkv biases drawn
    at random, as JAX arrays, and the port's model on them."""
    p, _ = jtfm.init_model(jax.random.PRNGKey(0), jconfigs.smoke_config(arch))
    p = jax.tree_util.tree_map(lambda a: np.array(a), p)
    attn = p["layers"]["pos0"]["attn"]
    rng = np.random.default_rng(3)
    for key in ("bq", "bk", "bv"):
        if key in attn:
            attn[key] = (0.5 * rng.normal(size=attn[key].shape)).astype(
                np.float32)
    model = convert.from_jax_params(p, tconfigs.smoke_config(arch),
                                    device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, p), model


def _tokens(arch):
    vocab = tconfigs.smoke_config(arch).vocab_size
    return np.random.default_rng(1).integers(0, vocab, (2, PROMPT)).astype(
        np.int32)


def _cfgs(arch, **knobs):
    """(JAX config, port config) with the same knobs."""
    return (dataclasses.replace(jconfigs.smoke_config(arch), **knobs),
            dataclasses.replace(tconfigs.smoke_config(arch), **knobs))


@pytest.mark.parametrize("arch", FAMILIES)
def test_weight_conversion_carries_biases(arch):
    jparams, model = _weights(arch)
    cfg = tconfigs.smoke_config(arch)
    jattn_p = jparams["layers"]["pos0"]["attn"]
    for i, layer in enumerate(model.layers):
        assert layer.attn.bias == cfg.qkv_bias
        keys = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv")
                                           if cfg.qkv_bias else ())
        for key in keys:
            np.testing.assert_array_equal(
                getattr(layer.attn, key).numpy(), np.asarray(jattn_p[key][i]))
        if not cfg.qkv_bias:
            assert not hasattr(layer.attn, "bq") and "bq" not in jattn_p
    if cfg.qkv_bias:
        assert tuple(model.layers[0].attn.bq.shape) == (cfg.n_heads, cfg.hd)
        assert tuple(model.layers[0].attn.bk.shape) == (cfg.n_kv_heads,
                                                        cfg.hd)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("style", ["2d", "half"])
def test_rope_matches_jax(rng, style, per_row):
    """chatglm's ``"2d"`` rotates the first half of each 16-wide head and
    passes the rest through."""
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = (rng.integers(0, 4000, (2, 5)) if per_row
           else np.arange(3, 8)).astype(np.int32)
    got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), style,
                           10000.0)
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), style, 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if style == "2d":
        np.testing.assert_array_equal(got[..., 8:].numpy(), x[..., 8:])


@pytest.mark.parametrize("mode", ["dense", "dual"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax(arch, mode):
    jparams, model = _weights(arch)
    jcfg, tcfg = _cfgs(arch, **(DUAL if mode == "dual" else {}))
    tokens = _tokens(arch)
    jout = jtfm.forward(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                        mode="prefill", rc=JRunConfig(**F32))
    tout = model({"tokens": torch.from_numpy(tokens).long()}, tcfg,
                 rc=TRunConfig(**F32))
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-34b", "chatglm3-6b"])
def test_generate_dual_matches_jax(arch):
    """Dual mode (K1's plain walk); yi-34b-smoke puts 7 query heads on a
    KV head."""
    jparams, model = _weights(arch)
    jcfg, tcfg = _cfgs(arch, **DUAL)
    jcfg = dataclasses.replace(jcfg, sparse_use_kernel=False)
    tokens = _tokens(arch)
    jt = jserve.generate(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                         max_new_tokens=NEW, rc=JRunConfig(**F32))
    tt = tserve.generate(model, {"tokens": torch.from_numpy(tokens)}, tcfg,
                         max_new_tokens=NEW, rc=TRunConfig(**F32),
                         device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("arch, knobs", [
    ("chatglm3-6b", {}),
    ("yi-34b", dict(DUAL, sparse_kv=True, sparse_block_t=8))])
def test_engine_matches_jax(arch, knobs):
    """Both engines, three staggered requests on two slots: tokens
    request for request (yi-34b-smoke in dual mode over sparse-KV
    pages)."""
    jparams, model = _weights(arch)
    jcfg, tcfg = _cfgs(arch, **knobs)
    jcfg = dataclasses.replace(jcfg, sparse_use_kernel=False)
    serve = dict(slots=2, capacity=32)
    je = jeng.Engine(jparams, jcfg, serve=JServeConfig(**serve),
                     rc=JRunConfig(**F32))
    te = teng.Engine(model, tcfg, serve=TServeConfig(**serve),
                     rc=TRunConfig(**F32), device="cpu")
    prompts = [[5, 6, 7, 8, 9, 10], [11, 3, 9, 2, 4], [8, 1, 2]]
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
