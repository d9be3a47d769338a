"""The engine's sparsity accounting against the JAX package's: the
``cost`` policy's StepCounts-tape admission cost and ``profile_sparsity``,
on ``nemotron-4-340b-smoke`` with the JAX parameters carried across by
``convert.from_jax_params`` (some of layer 0's MLP columns zeroed so the
sparse schedules skip), both engines in float32 activations.

The JAX engine runs its XLA path: its Pallas kernels in interpret mode
would take minutes here, and neither schedules nor costs depend on them,
only the executed step counts (the port's kernel path executes the steps
it schedules, held against JAX's kernels in ``test_torch_kvcache.py``).
The rest of the engine is in ``test_torch_engine.py``.
"""
import dataclasses

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
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.models import convert
from repro_torch.serving import engine as teng

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

ARCH = "nemotron-4-340b"
DUAL_KV = dict(sparse_mode="dual", sparse_use_kernel=True, sparse_kv=True,
               sparse_block_t=8)


@pytest.fixture(scope="module")
def setup():
    p, _ = jtfm.init_model(jax.random.PRNGKey(0), jsmoke(ARCH))
    p = jax.tree_util.tree_map(lambda a: np.array(a), p)
    p["layers"]["pos0"]["mlp"]["w_up"][:, :, :128] = 0
    model = convert.from_jax_params(p, tsmoke(ARCH), device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, p), model


def _engines(setup, serve, **knobs):
    """A JAX engine on its XLA path and a port engine on the same
    weights, float32 activations."""
    jparams, model = setup
    jcfg = dataclasses.replace(jsmoke(ARCH),
                               **dict(knobs, sparse_use_kernel=False))
    tcfg = dataclasses.replace(tsmoke(ARCH), **knobs)
    je = jeng.Engine(jparams, jcfg, serve=JServeConfig(**serve),
                     rc=JRunConfig(act_dtype="float32"))
    te = teng.Engine(model, tcfg, serve=TServeConfig(**serve),
                     rc=TRunConfig(act_dtype="float32"), device="cpu")
    return je, te


def _drain(eng, mod, prompts, max_new):
    """Submit the prompts, drain; returns {uid: request}, finish order."""
    for uid, p in enumerate(prompts):
        eng.submit(mod.Request(uid=uid, prompt=list(p),
                               max_new_tokens=max_new))
    done = eng.run_to_completion()
    return {r.uid: r for r in done}, [r.uid for r in done]


@pytest.mark.parametrize("mode", ["dense", "dual"])
def test_cost_policy(setup, mode):
    """The cost scheduler admits the cheapest queued request first: in
    dense mode by prompt length (the shorter prompt, submitted later,
    finishes first), in dual by the scheduled steps of a StepCounts-tape
    prefill — the same costs and the same order as JAX's."""
    serve = dict(slots=1, capacity=32, policy="cost")
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 9]]
    knobs = dict(sparse_mode="dual") if mode == "dual" else {}
    je, te = _engines(setup, serve, **knobs)
    jdone, jorder = _drain(je, jeng, prompts, 2)
    tdone, torder = _drain(te, teng, prompts, 2)
    assert torder == jorder
    assert te.scheduler._cost == je.scheduler._cost
    if mode == "dense":
        assert torder == [1, 0]
        assert te.scheduler._cost == {0: 7.0, 1: 2.0}
    else:
        assert all(c > 7 for c in te.scheduler._cost.values())
    for uid in range(2):
        assert tdone[uid].output == jdone[uid].output


@pytest.mark.parametrize("knobs", [
    DUAL_KV, dict(DUAL_KV, sparse_use_kernel=False), dict(sparse_mode="dual")],
    ids=["dual+kv", "dual+kv-plain", "dual"])
def test_profile_sparsity_matches_jax(setup, knobs):
    """Entry for entry: dense, scheduled and executed steps of every
    dispatch, the attention products' cache blocks with one schedule per
    row, and the caches' occupancy entries."""
    je, te = _engines(setup, dict(slots=2, capacity=32), **knobs)
    toks = np.array([[5, 6, 7, 8, 9], [1, 2, 3, 4, 0]], np.int32)
    want = je.profile_sparsity(toks, decode_steps=3)
    got = te.profile_sparsity(toks, decode_steps=3)
    assert len(got) == len(want)
    kernel = knobs.get("sparse_use_kernel", False)
    for g, w in zip(got, want):
        if "executed_steps" in g:
            # XLA executes dense; the port's kernel path what it schedules
            assert g["executed_steps"] == (g["sparse_steps"] if kernel
                                           else w["executed_steps"])
            w = dict(w, executed_steps=g["executed_steps"])
        assert g == {k: w[k] for k in g}, (g, w)
    names = [e["name"] for e in got]
    attn = [e for e in got if e["name"] in ("attn.score", "attn.value")]
    if knobs.get("sparse_kv"):
        assert len(attn) == 2 * 2 * 3
        assert names[-2:] == ["kvcache.pos0.layer0", "kvcache.pos0.layer1"]
        for e in attn:
            assert e["sparse_steps"] < e["dense_steps"]
    else:
        assert not attn and not any(n.startswith("kvcache") for n in names)
    dense_eng = _engines(setup, dict(slots=2, capacity=32))[1]
    assert dense_eng.profile_sparsity(toks) == []
