"""Model parity: the JAX ``init_model(PRNGKey(0))`` parameters of
``nemotron-4-340b-smoke`` go through ``from_jax_params``; the port's
``forward`` then matches the JAX ``forward`` in dense, dual (K1) and
dual+kcondense (K2): f32 logits within 1e-4 and the StepCounts tapes
equal.  bf16 is in ``test_torch_model_bf16.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.configs.base import RunConfig as JRunConfig
from repro.models import transformer as jtfm
from repro.sparse import tape as jtape
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.models import convert
from repro_torch.models import transformer as ttfm
from repro_torch.sparse import tape as ttape

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

ARCH = "nemotron-4-340b"
MODES = {
    "dense": dict(),
    "dual": dict(sparse_mode="dual", sparse_use_kernel=True),
    "dual+kc": dict(sparse_mode="dual", sparse_use_kernel=True,
                    sparse_kcondense=True),
}


@pytest.fixture(scope="module")
def params():
    """JAX parameters as numpy, with block-pruned weights so that the
    schedules skip (dead up-projection and LM-head block columns)."""
    p, _ = jtfm.init_model(jax.random.PRNGKey(0), jsmoke(ARCH))
    p = jax.tree_util.tree_map(lambda a: np.array(a), p)
    p["layers"]["pos0"]["mlp"]["w_up"][:, :, :128] = 0
    p["lm_head"][:, :128] = 0
    return p


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 512, (2, 7)).astype(np.int32)


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


def _forward_both(params, tokens, mode, dtype):
    jcfg = dataclasses.replace(jsmoke(ARCH), **MODES[mode])
    tcfg = dataclasses.replace(tsmoke(ARCH), **MODES[mode])
    rc = JRunConfig(act_dtype=dtype, scan_unroll=True)
    jout, je = _jax_taped(lambda p, b: jtfm.forward(
        p, b, jcfg, mode="prefill", rc=rc), params, {"tokens": tokens})
    model = convert.from_jax_params(
        params, tcfg, device="cpu",
        dtype=torch.float32 if dtype == "float32" else torch.bfloat16)
    with ttape.collect() as te:
        tout = model({"tokens": torch.from_numpy(tokens).long()}, tcfg,
                     rc=TRunConfig(act_dtype=dtype))
    return (np.asarray(jout.logits.astype(np.float32)),
            tout.logits.float().numpy(), jtape.summarize(je),
            ttape.summarize(te))


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_f32(params, tokens, mode):
    jl, tl, jsum, tsum = _forward_both(params, tokens, mode, "float32")
    assert tl.shape == (2, 7, 512)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    assert tsum == jsum
    if mode != "dense":
        assert len(tsum) == 13      # q/k/v/o/up/down × 2 layers + head
        assert all(e["executed_steps"] == e["sparse_steps"] for e in tsum)
        assert sum(e["sparse_steps"] for e in tsum) < \
            sum(e["dense_steps"] for e in tsum)


def test_plan_weight_activities_match_jax(params):
    """Cached weight plans equal the JAX plans, and forward with them
    equals forward without them."""
    jcfg = dataclasses.replace(jsmoke(ARCH), **MODES["dual+kc"])
    tcfg = dataclasses.replace(tsmoke(ARCH), **MODES["dual+kc"])
    jplans = jtfm.plan_weight_activities(params, jcfg)
    model = convert.from_jax_params(params, tcfg, device="cpu")
    tplans = ttfm.plan_weight_activities(model, tcfg)
    np.testing.assert_array_equal(tplans["lm_head"].numpy(),
                                  np.asarray(jplans["lm_head"]))
    jl = jplans["layers"]["pos0"]
    for i, layer in enumerate(tplans["layers"]):
        for blk, keys in (("attn", ("wq", "wk", "wv", "wo")),
                          ("mlp", ("w_up", "w_down", "w_up@elem",
                                   "w_down@elem"))):
            for key in keys:
                np.testing.assert_array_equal(
                    layer[blk][key].numpy(), np.asarray(jl[blk][key][i]))
    toks = {"tokens": torch.arange(6)[None]}
    rc = TRunConfig(act_dtype="float32")
    a = model(toks, tcfg, rc=rc, weight_plans=tplans).logits
    b = model(toks, tcfg, rc=rc).logits
    torch.testing.assert_close(a, b, atol=0, rtol=0)
