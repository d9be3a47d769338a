"""MoE model parity: the JAX ``init_model(PRNGKey(0))`` parameters of
``mixtral-8x7b-smoke`` (8 layers' worth of nothing: 2 layers, 4 experts
top-2, a 16-token sliding window) and ``qwen3-moe-235b-a22b-smoke`` (8
experts top-2) go through ``from_jax_params``; then, in float32:

* ``forward`` equals the JAX ``forward`` in dense, dual (K1 + K3) and
  dual+kcondense (K2 + K4): logits within 1e-4, ``aux_loss`` within 1e-6,
  the StepCounts tapes equal;
* prefill and decode logits, step by step past mixtral-smoke's window,
  within 1e-4 of the JAX serve loop's;
* ``plan_weight_activities`` equals the JAX plans, ``@elem`` included;
* ``generate`` emits the JAX ``generate``'s greedy tokens (dual);
* the port's ``Engine`` emits the JAX ``Engine``'s tokens request for
  request on mixtral-smoke (dual, sparse KV), decoding past its window.

The JAX serve loop and engine run their XLA path
(``sparse_use_kernel=False``), as in ``test_torch_engine.py``: neither
logits nor tokens nor schedules depend on it, and its Pallas kernels in
interpret mode would take minutes a decode; ``forward`` holds the port's
kernel path against JAX's kernels.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.models import transformer as jtfm
from repro.serving import engine as jeng
from repro.serving import serve_loop as jserve
from repro.sparse import tape as jtape
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.models import convert
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.serving import engine as teng
from repro_torch.serving import serve_loop as tserve
from repro_torch.sparse import tape as ttape

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b")
MODES = {
    "dense": dict(),
    "dual": dict(sparse_mode="dual", sparse_use_kernel=True),
    "dual+kc": dict(sparse_mode="dual", sparse_use_kernel=True,
                    sparse_kcondense=True),
}
# prompt and new tokens: 12 + 8 positions pass mixtral-smoke's window of 16
PROMPT, NEW = 12, 8


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The JAX parameters (as JAX arrays) and the port's model on them."""
    p, _ = jtfm.init_model(jax.random.PRNGKey(0), jsmoke(arch))
    p = jax.tree_util.tree_map(lambda a: np.array(a), p)
    model = convert.from_jax_params(p, tsmoke(arch), device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, p), model


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    tokens = np.random.default_rng(1).integers(0, 512, (2, PROMPT)).astype(
        np.int32)
    return (arch, *_weights(arch), tokens)


def _cfgs(arch, mode, **over):
    return (dataclasses.replace(jsmoke(arch), **MODES[mode], **over),
            dataclasses.replace(tsmoke(arch), **MODES[mode], **over))


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
def test_forward_matches_jax(setup, mode):
    arch, jparams, model, tokens = setup
    jcfg, tcfg = _cfgs(arch, mode)
    assert all(isinstance(layer.moe, tmoe.MoE) for layer in model.layers)
    rc = JRunConfig(act_dtype="float32", scan_unroll=True)
    jout, je = _jax_taped(lambda p, b: jtfm.forward(
        p, b, jcfg, mode="prefill", rc=rc), jparams,
        {"tokens": jnp.asarray(tokens)})
    with ttape.collect() as te:
        tout = model({"tokens": torch.from_numpy(tokens).long()}, tcfg,
                     rc=TRunConfig(act_dtype="float32"))
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               atol=1e-4, rtol=1e-4)
    assert abs(float(tout.aux_loss) - float(jout.aux_loss)) <= 1e-6
    assert float(tout.aux_loss) > 0
    tsum, jsum = ttape.summarize(te), jtape.summarize(je)
    assert tsum == jsum
    if mode != "dense":
        # q/k/v/o and the experts' up/gate/down a layer, then the head
        assert len(tsum) == 7 * 2 + 1
        assert all(e["executed_steps"] == e["sparse_steps"] for e in tsum)


def test_prefill_and_decode_logits_match_jax(setup):
    """dual+kc (K2 + K4's plain walks), step by step; the JAX steps each
    compiled once."""
    arch, jparams, model, tokens = setup
    jcfg, tcfg = _cfgs(arch, "dual+kc")
    jcfg = dataclasses.replace(jcfg, sparse_use_kernel=False)
    jrc, trc = JRunConfig(act_dtype="float32"), TRunConfig(act_dtype="float32")
    cap = PROMPT + NEW
    jstate, jl = jax.jit(jserve.make_prefill_step(jcfg, jrc))(
        jparams, {"tokens": jnp.asarray(tokens)},
        jtfm.init_caches(jcfg, 2, cap))
    tstate, tl = tserve.make_prefill_step(tcfg, trc)(
        model, {"tokens": torch.from_numpy(tokens).long()},
        ttfm.init_caches(tcfg, 2, cap, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    jdec = jax.jit(jserve.make_decode_step(jcfg, jrc))
    tdec = tserve.make_decode_step(tcfg, trc)
    for _ in range(NEW - 1):
        jstate, jl = jdec(jparams, jstate)
        tstate, tl = tdec(model, tstate)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(tstate.last_token.numpy(),
                                      np.asarray(jstate.last_token))


def test_plan_weight_activities_match_jax(setup):
    arch, jparams, model, tokens = setup
    jcfg, tcfg = _cfgs(arch, "dual+kc")
    jplans = jtfm.plan_weight_activities(jparams, jcfg)
    tplans = ttfm.plan_weight_activities(model, tcfg)
    np.testing.assert_array_equal(tplans["lm_head"].numpy(),
                                  np.asarray(jplans["lm_head"]))
    jl = jplans["layers"]["pos0"]
    keys = ("w_up", "w_gate", "w_down")
    for i, layer in enumerate(tplans["layers"]):
        assert sorted(layer["moe"]) == sorted(
            [*keys, *(f"{k}@elem" for k in keys)])
        for blk in ("attn", "moe"):
            for key, plan in layer[blk].items():
                np.testing.assert_array_equal(plan.numpy(),
                                              np.asarray(jl[blk][key][i]))
    toks = {"tokens": torch.from_numpy(tokens).long()}
    rc = TRunConfig(act_dtype="float32")
    a = model(toks, tcfg, rc=rc, weight_plans=tplans).logits
    b = model(toks, tcfg, rc=rc).logits
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_generate_matches_jax(setup):
    """dual (K1 + K3's plain walks); dense greedy tokens are the same
    forward with the dispatch bypassed, which the forward test holds."""
    arch, jparams, model, tokens = setup
    jcfg, tcfg = _cfgs(arch, "dual")
    jcfg = dataclasses.replace(jcfg, sparse_use_kernel=False)
    jt = jserve.generate(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                         max_new_tokens=NEW,
                         rc=JRunConfig(act_dtype="float32"))
    tt = tserve.generate(model, {"tokens": torch.from_numpy(tokens)}, tcfg,
                         max_new_tokens=NEW,
                         rc=TRunConfig(act_dtype="float32"), device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_engine_matches_jax_past_the_window():
    """Staggered requests through both engines on mixtral-smoke in dual
    mode over sparse-KV pages (MoE models prefill at exact length, one
    request a call); every request decodes past the 16-token window,
    where its first pages are reclaimed."""
    arch = "mixtral-8x7b"
    jparams, model = _weights(arch)
    jcfg, tcfg = _cfgs(arch, "dual", sparse_kv=True, sparse_block_t=8)
    jcfg = dataclasses.replace(jcfg, sparse_use_kernel=False)
    serve = dict(slots=2, capacity=32)
    je = jeng.Engine(jparams, jcfg, serve=JServeConfig(**serve),
                     rc=JRunConfig(act_dtype="float32"))
    te = teng.Engine(model, tcfg, serve=TServeConfig(**serve),
                     rc=TRunConfig(act_dtype="float32"), device="cpu")
    prompts = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14],
               [11, 3, 9, 2, 4, 8, 1, 2, 3, 4, 5, 6],
               [8, 1, 2, 3, 4, 5]]
    done = {}
    for eng, mod in ((je, jeng), (te, teng)):
        out = []
        for uid, prompt in enumerate(prompts):
            eng.submit(mod.Request(uid=uid, prompt=list(prompt),
                                   max_new_tokens=12))
            out.extend(eng.step())
        out.extend(eng.run_to_completion())
        done[mod] = {r.uid: list(r.output) for r in out}
    assert done[teng] == done[jeng]
    assert all(len(t) == 12 for t in done[teng].values())
    assert max(len(q) for q in prompts) + 12 > tsmoke(arch).sliding_window
