"""Whisper parity: the JAX ``init_model(PRNGKey(0))`` parameters of
``whisper-base-smoke`` go through ``from_jax_params``, and the port
matches the JAX package on the same numpy mel frames and prompts, in
float32, in dense, dual and dual+kcondense: the conv frontend and the
``forward`` logits within 1e-4 (the same float32 products summed in
another order), the per-site StepCounts tape bit for bit, and
``generate``'s tokens equal to those of JAX ``generate``'s steps, with
per-step logits within 1e-4, for ``max_new_tokens`` in {0, 1, 2, 8}.

The JAX package runs with ``use_kernel=False`` (its Pallas conv kernels
cannot run here), and its forward with ``scan_unroll=True, remat="none"``
so that every layer's dispatch lands on its tape (under ``lax.scan`` or
``jax.checkpoint`` the entries are traced and skipped).  The port runs
its kernels' plain versions (``sparse_use_kernel=True`` on CPU tensors).
Small blocks, a silent band of mel bins and block-pruned weights make the
schedules skip."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.configs.base import RunConfig as JRunConfig
from repro.models import frontend as jfem
from repro.models import transformer as jtfm
from repro.serving import serve_loop as jserve
from repro.sparse import tape as jtape
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.models import convert
from repro_torch.models import frontend as tfem
from repro_torch.models import transformer as ttfm
from repro_torch.serving import serve_loop as tserve
from repro_torch.sparse import tape as ttape

torch.set_num_threads(1)

ARCH = "whisper-base"
GEOM = dict(sparse_block_m=16, sparse_block_n=16, sparse_slice_k=16)
MODES = {
    "dense": dict(),
    "dual": dict(sparse_mode="dual", **GEOM),
    "dual+kc": dict(sparse_mode="dual", sparse_kcondense=True, **GEOM),
}
NEW = 8
F32 = dict(act_dtype="float32")


def _cfgs(mode):
    jcfg = dataclasses.replace(jsmoke(ARCH), **MODES[mode])
    kern = {} if mode == "dense" else dict(sparse_use_kernel=True)
    tcfg = dataclasses.replace(tsmoke(ARCH), **MODES[mode], **kern)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def params():
    """JAX parameters as numpy, with dead filters in conv1 and dead
    block columns in every w_up and the LM head."""
    init = jax.jit(lambda key: jtfm.init_model(key, jsmoke(ARCH))[0])
    p = jax.tree_util.tree_map(lambda a: np.array(a),
                               init(jax.random.PRNGKey(0)))
    p["frontend"]["conv1"][..., :16] = 0
    p["layers"]["pos0"]["mlp"]["w_up"][..., :16] = 0
    p["enc_layers"]["pos0"]["mlp"]["w_up"][..., :16] = 0
    p["lm_head"][:, :16] = 0
    return p


@pytest.fixture(scope="module")
def jparams(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.fixture(scope="module")
def inputs():
    """2 segments of 48 ReLU-clipped normal mel frames (as the JAX
    package's ``frontend_inputs``) with bins 10-15 silent, and 4-token
    prompts."""
    rng = np.random.default_rng(0)
    cfg = tsmoke(ARCH)
    mel = np.maximum(rng.standard_normal(
        (2, 2 * cfg.encoder_len, cfg.n_mels)), 0).astype(np.float32)
    mel[..., 10:] = 0
    tokens = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    return mel, tokens


def _tbatch(inputs):
    mel, tokens = inputs
    return {"tokens": torch.from_numpy(tokens).long(),
            "mel": torch.from_numpy(mel)}


def _jbatch(inputs):
    mel, tokens = inputs
    return {"tokens": jnp.asarray(tokens), "mel": jnp.asarray(mel)}


@pytest.fixture(scope="module")
def jax_runs(jparams, inputs):
    """Per mode, computed once: the NEW tokens and the logits of JAX
    ``generate``'s own steps (its prefill step, then its decode step
    NEW - 1 times), each step compiled once."""
    runs = {}

    def run(mode):
        if mode not in runs:
            jcfg, _ = _cfgs(mode)
            rc = JRunConfig(**F32)
            caches = jtfm.init_caches(jcfg, 2, 4 + NEW)
            state, lg = jax.jit(jserve.make_prefill_step(jcfg, rc))(
                jparams, _jbatch(inputs), caches)
            toks, steps = [state.last_token], [np.asarray(lg[:, -1])]
            decode = jax.jit(jserve.make_decode_step(jcfg, rc))
            for _ in range(NEW - 1):
                state, lg = decode(jparams, state)
                toks.append(state.last_token)
                steps.append(np.asarray(lg))
            runs[mode] = (np.concatenate(toks, axis=1), steps)
        return runs[mode]
    return run


@pytest.mark.parametrize("mode", list(MODES))
def test_audio_frontend_matches_jax(params, jparams, inputs, mode):
    jcfg, tcfg = _cfgs(mode)
    mel = inputs[0]
    want = jax.jit(lambda fp, m: jfem.audio_frontend(fp, m, jcfg))(
        jparams["frontend"], jnp.asarray(mel))
    model = convert.from_jax_params(params, tcfg, device="cpu")
    got = tfem.audio_frontend(model.frontend, torch.from_numpy(mel), tcfg)
    assert tuple(got.shape) == (2, tcfg.encoder_len, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _jax_taped(fn, *args):
    """``fn(*args)`` (JAX) compiled with ``jax.jit``, and its stats tape:
    the entries recorded while it traces (names, StepCounts, executed
    steps) come back as outputs of the compiled call, so the tape holds
    the values an eager call records op by op, at a fraction of the eager
    run's time."""
    names = []

    def traced(*a):
        with jtape.collect() as entries:
            out = fn(*a)
        names[:] = [e[0] for e in entries]
        return out, [e[1:] for e in entries]
    out, rest = jax.jit(traced)(*args)
    return out, [(name, *r) for name, r in zip(names, rest)]


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_f32(params, jparams, inputs, mode):
    jcfg, tcfg = _cfgs(mode)
    rc = JRunConfig(scan_unroll=True, remat="none", **F32)
    jout, je = _jax_taped(lambda p, b: jtfm.forward(
        p, b, jcfg, mode="prefill", rc=rc), jparams, _jbatch(inputs))
    model = convert.from_jax_params(params, tcfg, device="cpu")
    with ttape.collect() as te:
        tout = model(_tbatch(inputs), tcfg, rc=TRunConfig(**F32))
    assert tuple(tout.logits.shape) == (2, 4, tcfg.vocab_size)
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               atol=1e-4, rtol=1e-4)
    jsum, tsum = jtape.summarize(je), ttape.summarize(te)
    strip = ("name", "dense_steps", "sparse_steps", "tiles_skipped")
    assert [[e[k] for k in strip] for e in tsum] == \
        [[e[k] for k in strip] for e in jsum]
    assert [e["name"] for e in tsum[:2]] == ["conv.stem1", "conv.stem2"]
    if mode == "dense":
        assert len(tsum) == 2            # only the convs record in dense
        return
    # stems 2, encoder 2 x 6, decoder 2 x 10, head 1
    assert len(tsum) == 35
    assert all(e["executed_steps"] == e["sparse_steps"] for e in tsum)
    for name in ("conv.stem1", "mlp.down", "lm_head"):
        assert any(e["name"] == name and e["sparse_steps"] < e["dense_steps"]
                   for e in tsum), name


@pytest.mark.parametrize("n", [0, 1, 2, NEW])
@pytest.mark.parametrize("mode", list(MODES))
def test_generate_tokens(params, inputs, jax_runs, mode, n):
    _, tcfg = _cfgs(mode)
    model = convert.from_jax_params(params, tcfg, device="cpu")
    got = tserve.generate(model, _tbatch(inputs), tcfg, max_new_tokens=n,
                          rc=TRunConfig(**F32), device="cpu")
    want, _ = jax_runs(mode)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, n)
    np.testing.assert_array_equal(got.numpy(), want[:, :n])


@pytest.mark.parametrize("mode", list(MODES))
def test_stepwise_logits(params, inputs, jax_runs, mode):
    """Prefill and every decode step's logits within 1e-4 of JAX's, the
    port fed its own tokens (equal to JAX's, per test_generate_tokens)."""
    _, tcfg = _cfgs(mode)
    model = convert.from_jax_params(params, tcfg, device="cpu")
    rc = TRunConfig(**F32)
    caches = ttfm.init_caches(tcfg, 2, 4 + NEW, device="cpu")
    state, lg = tserve.make_prefill_step(tcfg, rc)(model, _tbatch(inputs),
                                                   caches)
    got = [lg[:, -1]]
    decode = tserve.make_decode_step(tcfg, rc)
    for _ in range(NEW - 1):
        state, lg = decode(model, state)
        got.append(lg)
    _, want = jax_runs(mode)
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {t}")


def test_plan_weight_activities_match_jax(params, inputs):
    """Cached weight plans (encoder, decoder with cross-attention, stem
    convs, head) equal the JAX plans, and forward with them equals
    forward without them."""
    jcfg, tcfg = _cfgs("dual+kc")
    jplans = jtfm.plan_weight_activities(params, jcfg)
    model = convert.from_jax_params(params, tcfg, device="cpu")
    tplans = ttfm.plan_weight_activities(model, tcfg)
    np.testing.assert_array_equal(tplans["lm_head"].numpy(),
                                  np.asarray(jplans["lm_head"]))
    for key, val in tplans["frontend"].items():
        np.testing.assert_array_equal(val.numpy(),
                                      np.asarray(jplans["frontend"][key]))
    for stack in ("layers", "enc_layers"):
        jl = jplans[stack]["pos0"]
        for i, layer in enumerate(tplans[stack]):
            assert set(layer) == set(jl)
            for blk, plans in layer.items():
                for key, val in plans.items():
                    np.testing.assert_array_equal(
                        val.numpy(), np.asarray(jl[blk][key][i]))
    rc = TRunConfig(**F32)
    a = model(_tbatch(inputs), tcfg, rc=rc, weight_plans=tplans).logits
    b = model(_tbatch(inputs), tcfg, rc=rc).logits
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_encoder_decoder_needs_the_memory(params):
    _, tcfg = _cfgs("dense")
    model = convert.from_jax_params(params, tcfg, device="cpu")
    with pytest.raises(ValueError, match="mel"):
        model({"tokens": torch.zeros(1, 3, dtype=torch.long)}, tcfg)
