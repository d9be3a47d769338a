"""Serving parity: ``generate`` emits the JAX package's greedy tokens in f32,
exactly ``max_new_tokens`` of them (the 0/1/2/8 edge cases of
``tests/test_serving.py``), in dense, dual (K1) and dual+kcondense (K2)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.configs.base import RunConfig as JRunConfig
from repro.models import transformer as jtfm
from repro.serving import serve_loop as jserve
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.models import convert
from repro_torch.serving import serve_loop as tserve

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
def setup():
    p, _ = jtfm.init_model(jax.random.PRNGKey(0), jsmoke(ARCH))
    p = jax.tree_util.tree_map(lambda a: np.array(a), p)
    p["layers"]["pos0"]["mlp"]["w_up"][:, :, :128] = 0
    model = convert.from_jax_params(p, tsmoke(ARCH), device="cpu")
    tokens = np.random.default_rng(1).integers(0, 512, (2, 5)).astype(
        np.int32)
    return p, model, tokens


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("max_new", [0, 1, 2, 8])
def test_generate_tokens_match_jax(setup, mode, max_new):
    params, model, tokens = setup
    jcfg = dataclasses.replace(jsmoke(ARCH), **MODES[mode])
    tcfg = dataclasses.replace(tsmoke(ARCH), **MODES[mode])
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jt = jserve.generate(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                         max_new_tokens=max_new,
                         rc=JRunConfig(act_dtype="float32"))
    tt = tserve.generate(model, {"tokens": torch.from_numpy(tokens)}, tcfg,
                         max_new_tokens=max_new,
                         rc=TRunConfig(act_dtype="float32"), device="cpu")
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (2, max_new)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_stepwise_matches_generate(setup):
    """prefill + decode steps driven by hand == generate."""
    _, model, tokens = setup
    cfg = dataclasses.replace(tsmoke(ARCH), **MODES["dual"])
    rc = TRunConfig(act_dtype="float32")
    toks = torch.from_numpy(tokens).long()
    fast = tserve.generate(model, {"tokens": toks}, cfg, max_new_tokens=4,
                           capacity=16, rc=rc, device="cpu")
    from repro_torch.models import transformer as ttfm
    caches = ttfm.init_caches(cfg, 2, 16, device="cpu")
    state, logits = tserve.make_prefill_step(cfg, rc)(
        model, {"tokens": toks}, caches)
    assert tuple(logits.shape) == (2, 5, 512)
    slow = [state.last_token[:, 0]]
    decode = tserve.make_decode_step(cfg, rc)
    for _ in range(3):
        state, _ = decode(model, state)
        slow.append(state.last_token[:, 0])
    assert state.pos == 8
    torch.testing.assert_close(fast, torch.stack(slow, 1).to(torch.int32))
