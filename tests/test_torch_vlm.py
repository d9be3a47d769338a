"""The VLM against the JAX package: the JAX ``init_model(PRNGKey(0))``
parameters of ``llama-3.2-vision-90b-smoke`` (10 layers: two periods of
a tanh-gated cross layer and 4 self layers; a 4 x 4 patch conv over
16 x 16 x 3 images, 16 image tokens) go through ``from_jax_params`` with
every ``gate_attn`` set non-zero (at init it is zero, and tanh(0) would
multiply the image away).  Then, in float32:

* the configs, ``layer_kind``, ``period`` and ``n_periods`` equal the
  JAX ones, full size and smoke;
* every port parameter equals its JAX leaf at ``pos{i % 5}``, period
  ``i // 5``, the frontend's too; the weight plans equal the JAX plans;
* ``vision_frontend`` alone within 1e-4, without a cls token (16
  tokens) and with one (17), dense and dual, its ``conv.patch`` steps
  equal;
* ``forward`` logits within 1e-4 in dense and dual, and the image
  changes them;
* a prefill and decode steps match one full forward;
* ``generate`` emits the JAX ``generate``'s tokens in dual+kv on int8
  caches (``rc.kv_quant``), whose cross caches stay bf16 and plain;
* the stubs: ``image_embeds`` into the VLM and ``frames`` into whisper's
  encoder, each without a conv frontend;
* the ``Engine`` refuses the VLM with ``ValueError``.

The JAX side runs its XLA path (``sparse_use_kernel=False``: its Pallas
conv kernels cannot run here); the port runs its kernels' plain
versions (``sparse_use_kernel=True`` on CPU tensors).  The JAX outputs
are computed once a module and shared between cases.
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
from repro.models import frontend as jfem
from repro.models import transformer as jtfm
from repro.serving import serve_loop as jserve
from repro.sparse import tape as jtape
import repro_torch.configs as tconfigs
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.models import cache as tcache
from repro_torch.models import convert
from repro_torch.models import frontend as tfem
from repro_torch.models import transformer as ttfm
from repro_torch.serving import engine as teng
from repro_torch.serving import serve_loop as tserve
from repro_torch.sparse import tape as ttape

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-90b"
SMOKE = f"{ARCH}-smoke"
F32 = dict(act_dtype="float32")
GEOM = dict(sparse_block_m=16, sparse_block_n=16, sparse_slice_k=16)
MODES = {"dense": dict(), "dual": dict(sparse_mode="dual", **GEOM)}
KV = dict(sparse_mode="dual", sparse_kv=True, sparse_block_t=8)
GATES = (0.7, -0.5)             # gate_attn of the two cross layers
PROMPT, NEW = 9, 6


def _cfgs(knobs=(), name=SMOKE):
    """(JAX config, port config) with the same knobs; the port's sparse
    modes run the kernels' plain versions."""
    knobs = dict(knobs)
    jcfg = dataclasses.replace(jconfigs.get_config(name), **knobs)
    kern = dict(sparse_use_kernel=True) if knobs.get(
        "sparse_mode", "dense") != "dense" else {}
    tcfg = dataclasses.replace(tconfigs.get_config(name), **knobs, **kern)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _numpy_params():
    jcfg, _ = _cfgs()
    init = jax.jit(lambda key: jtfm.init_model(key, jcfg)[0])
    p = jax.tree_util.tree_map(np.array, init(jax.random.PRNGKey(0)))
    p["layers"]["pos0"]["gate_attn"][:] = GATES
    return p


@functools.lru_cache(maxsize=None)
def _weights(frontend_conv=True):
    """JAX parameters (as JAX arrays, the gates non-zero) and the port's
    model on them; without ``frontend_conv``, the same less the frontend
    (the stub's tree)."""
    _, tcfg = _cfgs(dict(frontend_conv=frontend_conv))
    p = dict(_numpy_params())
    if not frontend_conv:
        del p["frontend"]
    model = convert.from_jax_params(p, tcfg, device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, p), model


@pytest.fixture(scope="module")
def inputs():
    """Two ReLU-clipped normal images (the JAX package's
    ``frontend_inputs``), another two for the swap, and prompts."""
    rng = np.random.default_rng(0)
    cfg = tconfigs.get_config(SMOKE)
    shape = (2, cfg.image_size, cfg.image_size, cfg.image_channels)
    images = np.maximum(rng.standard_normal(shape), 0).astype(np.float32)
    other = np.maximum(rng.standard_normal(shape), 0).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    return images, other, tokens


def _batches(tokens, **memory):
    """The same batch for JAX and for the port."""
    jb = {"tokens": jnp.asarray(tokens),
          **{k: jnp.asarray(v) for k, v in memory.items()}}
    tb = {"tokens": torch.from_numpy(tokens).long(),
          **{k: torch.from_numpy(v) for k, v in memory.items()}}
    return jb, tb


@pytest.fixture(scope="module")
def jax_forward(inputs):
    """JAX ``forward`` logits (train mode) by mode, computed once."""
    images, _, tokens = inputs
    jparams, _ = _weights()
    jb, _ = _batches(tokens, images=images)
    out = {}
    for mode, knobs in MODES.items():
        jcfg, _ = _cfgs(knobs)
        out[mode] = np.asarray(jtfm.forward(jparams, jb, jcfg, mode="train",
                                            rc=JRunConfig(**F32)).logits)
    return out


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [ARCH, SMOKE])
def test_configs_match_jax(name):
    tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
    tnames = {f.name for f in dataclasses.fields(tcfg)}
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), \
            field.name
    for field in dataclasses.fields(jcfg):
        if field.name not in tnames:
            assert getattr(jcfg, field.name) == field.default, field.name
    for prop in ("hd", "period", "n_periods"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    assert tcfg.period == 5
    for pos in range(2 * tcfg.period):
        assert tcfg.layer_kind(pos) == jcfg.layer_kind(pos), pos
    assert [tcfg.layer_kind(p) for p in range(5)] == ["cross"] + ["attn"] * 4
    assert tconfigs.get_run_config(name, "decode_32k") == \
        TRunConfig(kv_quant=name == ARCH)
    assert ARCH in tconfigs.list_archs()
    assert [s.name for s in tconfigs.runnable_shapes(name)] == [
        s.name for s in jconfigs.runnable_shapes(name)]
    # the vision checks of __post_init__
    for bad in (dict(patch_size=5), dict(num_image_tokens=15)):
        with pytest.raises(ValueError):
            dataclasses.replace(tcfg, **bad)
        with pytest.raises(ValueError):
            dataclasses.replace(jcfg, **bad)


def test_from_jax_params_maps_periods():
    jparams, model = _weights()
    tparams = dict(model.named_parameters())
    seen = set()
    for i, layer in enumerate(model.layers):
        assert layer.kind == ("cross" if i % 5 == 0 else "attn")
        stack = jparams["layers"][f"pos{i % 5}"]
        for path, leaf in jax.tree_util.tree_flatten_with_path(stack)[0]:
            tname = f"layers.{i}." + ".".join(k.key for k in path)
            np.testing.assert_array_equal(tparams[tname].numpy(),
                                          np.asarray(leaf[i // 5]),
                                          err_msg=tname)
            seen.add(tname)
    assert seen == {k for k in tparams if k.startswith("layers.")}
    assert [model.layers[i].gate_attn.item() for i in (0, 5)] == \
        pytest.approx(GATES)
    assert not hasattr(model.layers[1], "gate_attn")
    for key, leaf in jparams["frontend"].items():
        np.testing.assert_array_equal(tparams[f"frontend.{key}"].numpy(),
                                      np.asarray(leaf))
    assert model.frontend.cls is None


def test_plan_weight_activities_match_jax():
    jparams, model = _weights()
    jcfg, tcfg = _cfgs(MODES["dual"])
    jplans = jtfm.plan_weight_activities(jparams, jcfg)
    tplans = ttfm.plan_weight_activities(model, tcfg)
    for i, lp in enumerate(tplans["layers"]):
        jlp = jplans["layers"][f"pos{i % 5}"]
        assert set(lp) == set(jlp) == {"attn", "mlp"}, i
        for blk, plans in lp.items():
            for key, act in plans.items():
                np.testing.assert_array_equal(
                    act.numpy(), np.asarray(jlp[blk][key][i // 5]))
    assert set(tplans["frontend"]) == set(jplans["frontend"]) == {"patch"}
    np.testing.assert_array_equal(tplans["frontend"]["patch"].numpy(),
                                  np.asarray(jplans["frontend"]["patch"]))
    np.testing.assert_array_equal(tplans["lm_head"].numpy(),
                                  np.asarray(jplans["lm_head"]))


# ---------------------------------------------------------------------------
# the vision frontend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n_tokens", [16, 17])
def test_vision_frontend_matches_jax(inputs, n_tokens, mode):
    """The patch conv, the bias, the cls token (17 = the 4 x 4 grid + 1)
    and the positions, on the frontend's own weights."""
    images = inputs[0]
    jcfg, tcfg = _cfgs(dict(MODES[mode], num_image_tokens=n_tokens))
    fp = jfem.init_vision_frontend(jax.random.PRNGKey(3), jcfg)
    fp = {k: np.array(v.value) for k, v in fp.items()}
    assert ("cls" in fp) == (n_tokens == 17)
    fp["bias"] = np.linspace(-1, 1, tcfg.d_model, dtype=np.float32)
    front = tfem.VisionFrontend(tcfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for key, p in front.named_parameters():
            p.copy_(torch.from_numpy(fp[key]))
    with jtape.collect() as jentries:
        want = jfem.vision_frontend({k: jnp.asarray(v) for k, v in fp.items()},
                                    jnp.asarray(images), jcfg)
    with ttape.collect() as tentries:
        got = tfem.vision_frontend(front, torch.from_numpy(images), tcfg)
    assert got.shape == (2, n_tokens, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    jrows = [(e["name"], e["dense_steps"], e["sparse_steps"])
             for e in jtape.summarize(jentries)]
    trows = [(e["name"], e["dense_steps"], e["sparse_steps"])
             for e in ttape.summarize(tentries)]
    assert trows == jrows and trows[0][0] == "conv.patch"


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_forward_matches_jax(inputs, jax_forward, mode):
    images, other, tokens = inputs
    _, model = _weights()
    _, tcfg = _cfgs(MODES[mode])
    _, tb = _batches(tokens, images=images)
    got = model(tb, tcfg, rc=TRunConfig(**F32)).logits.numpy()
    np.testing.assert_allclose(got, jax_forward[mode], atol=1e-4, rtol=1e-4)
    # the image reaches the logits through the gated cross layers
    _, swapped = _batches(tokens, images=other)
    moved = model(swapped, tcfg, rc=TRunConfig(**F32)).logits.numpy()
    assert np.abs(moved - got).max() > 100 * 1e-4 * np.abs(got).max()


def test_prefill_then_decode_matches_forward(inputs, jax_forward):
    """A prefill of PROMPT - 3 tokens into 16-slot float32 caches, then
    the 3 last tokens one decode step each (the cross layers reading their
    filled caches): each step's logits against the JAX full forward's at
    its position."""
    images, _, tokens = inputs
    _, model = _weights()
    _, tcfg = _cfgs(MODES["dual"])
    rc = TRunConfig(**F32)
    s = PROMPT - 3
    caches = ttfm.init_caches(tcfg, 2, 16, dtype=torch.float32,
                              device="cpu")
    _, tb = _batches(tokens[:, :s], images=images)
    out = model(tb, tcfg, caches=caches, positions=torch.arange(s), rc=rc)
    got = [out.logits[:, -1]]
    for t in range(s, PROMPT):
        out = model({"tokens": torch.from_numpy(tokens[:, t:t + 1]).long()},
                    tcfg, caches=out.caches, positions=torch.tensor([t]),
                    rc=rc)
        got.append(out.logits[:, 0])
    want = jax_forward["dual"][:, s - 1:]
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want, atol=1e-4,
                               rtol=1e-4)
    with pytest.raises(ValueError):
        model({"tokens": torch.from_numpy(tokens).long()}, tcfg, rc=rc)


def test_generate_dual_kv_int8_matches_jax(inputs):
    """dual+kv on int8 caches: the self layers' SparseKVCaches int8, the
    cross layers' plain bf16 caches of num_image_tokens slots, as the
    JAX package's."""
    images, _, tokens = inputs
    jparams, model = _weights()
    jcfg, tcfg = _cfgs(KV)
    jcfg = dataclasses.replace(jcfg, sparse_use_kernel=False)
    jcaches = jtfm.init_caches(jcfg, 2, 32, quantized=True)
    tcaches = ttfm.init_caches(tcfg, 2, 32, quantized=True, device="cpu")
    for i, c in enumerate(tcaches):
        jc = jcaches[f"pos{i % 5}"]["kv"]
        if i % 5:
            assert c.quantized and c.k.dtype == torch.int8
            continue
        assert type(c) is tcache.KVCache and not c.quantized
        assert c.k.dtype == torch.bfloat16 and c.k_scale is None
        assert tuple(c.k.shape) == tuple(jc.k.shape[1:]) == (
            2, tcfg.num_image_tokens, tcfg.n_kv_heads, tcfg.hd)
        assert jc.k.dtype == jnp.bfloat16
    jb, tb = _batches(tokens, images=images)
    jt = jserve.generate(jparams, jb, jcfg, max_new_tokens=NEW,
                         rc=JRunConfig(kv_quant=True, **F32))
    tt = tserve.generate(model, tb, tcfg, max_new_tokens=NEW,
                         rc=TRunConfig(kv_quant=True, **F32), device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_image_embeds_stub_matches_jax(inputs):
    """Without ``frontend_conv`` the model has no frontend and reads the
    precomputed ``image_embeds`` (plain normals) as its memory: the
    forward's logits and ``generate``'s tokens (dense)."""
    _, _, tokens = inputs
    jparams, model = _weights(frontend_conv=False)
    jcfg, tcfg = _cfgs(dict(frontend_conv=False))
    assert "frontend" not in jparams and not hasattr(model, "frontend")
    embeds = np.random.default_rng(5).standard_normal(
        (2, tcfg.num_image_tokens, tcfg.d_model)).astype(np.float32)
    jb, tb = _batches(tokens, image_embeds=embeds)
    rc = JRunConfig(**F32)
    want = jax.jit(lambda p_, b_: jtfm.forward(p_, b_, jcfg, mode="train",
                                               rc=rc).logits)(jparams, jb)
    got = model(tb, tcfg, rc=TRunConfig(**F32))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    jt = jserve.generate(jparams, jb, jcfg, max_new_tokens=3, rc=rc)
    tt = tserve.generate(model, tb, tcfg, max_new_tokens=3,
                         rc=TRunConfig(**F32), device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_audio_frames_stub_matches_jax():
    """whisper-base-smoke without its conv stem: the encoder reads the
    precomputed ``frames`` (plain normals)."""
    jcfg, tcfg = _cfgs(dict(frontend_conv=False), name="whisper-base-smoke")
    init = jax.jit(lambda key: jtfm.init_model(key, jcfg)[0])
    p = jax.tree_util.tree_map(np.array, init(jax.random.PRNGKey(0)))
    assert "frontend" not in p
    model = convert.from_jax_params(p, tcfg, device="cpu")
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((2, tcfg.encoder_len, tcfg.d_model)
                                 ).astype(np.float32)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 4)).astype(np.int32)
    jb, tb = _batches(tokens, frames=frames)
    want = jax.jit(lambda p_, b_: jtfm.forward(
        p_, b_, jcfg, mode="train", rc=JRunConfig(**F32)).logits)(
            jax.tree_util.tree_map(jnp.asarray, p), jb)
    got = model(tb, tcfg, rc=TRunConfig(**F32)).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_engine_refuses_vlm():
    """The paged engine serves no cross-attention stack: the JAX engine's
    legacy plane for them is not ported (it raises KeyError for every
    config that reaches it), so construction raises ValueError."""
    _, model = _weights()
    _, tcfg = _cfgs(KV)
    with pytest.raises(ValueError, match="paged serving"):
        teng.Engine(model, tcfg, slots=2, capacity=32, device="cpu")
    with pytest.raises(ValueError, match="paged serving"):
        ttfm.init_paged_caches(tcfg, 2, 8, 8, 32, device="cpu")
