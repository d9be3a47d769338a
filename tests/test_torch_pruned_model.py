"""Block-pruned smoke models served on cached weight plans, against the
JAX package: ``nemotron-4-340b-smoke`` and ``whisper-base-smoke``, every
layer's ``mlp.w_up`` and ``mlp.w_down`` block-pruned at (slice_k,
block_n) by each side's own ``block_mask``, through
``forward(weight_plans=)`` with each side's cached plans
(``plan_weight_activities``): float32 logits within 1e-4 (the same
float32 products summed in another order) and the StepCounts tape bit for
bit.  Small blocks (16) make the schedules skip.  JAX runs its plain
products (``use_kernel=False``: the same schedules and counts, no
interpret-mode kernels) and its forward unrolled, as
``test_torch_whisper.py`` explains; the port runs its kernels' plain
versions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.configs.base import RunConfig as JRunConfig
from repro.core import pruning as jpr
from repro.models import transformer as jtfm
from repro.sparse import tape as jtape
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.core import pruning as tpr
from repro_torch.models import convert
from repro_torch.models import transformer as ttfm
from repro_torch.sparse import tape as ttape

torch.set_num_threads(1)

GEOM = dict(sparse_block_m=16, sparse_block_n=16, sparse_slice_k=16)
MODES = {
    "dual": dict(sparse_mode="dual", **GEOM),
    "dual+kc": dict(sparse_mode="dual", sparse_kcondense=True, **GEOM),
}


def _prune_jax(params, jcfg):
    """Each layer's w_up and w_down (stacked over layers) block-pruned at
    (slice_k, block_n), layer by layer, by the JAX ``block_mask``."""
    block = (jcfg.sparse_slice_k, jcfg.sparse_block_n)
    for stack in ("layers", "enc_layers"):
        if stack not in params:
            continue
        mlp = params[stack]["pos0"]["mlp"]
        for key in ("w_up", "w_down"):
            w = mlp[key]
            masks = [np.asarray(jpr.block_mask(jnp.asarray(w[i]), 0.5,
                                               block=block))
                     for i in range(w.shape[0])]
            mlp[key] = w * np.stack(masks).astype(w.dtype)
    return params


def _prune_torch(model, tcfg):
    block = (tcfg.sparse_slice_k, tcfg.sparse_block_n)
    layers = list(model.layers) + list(getattr(model, "enc_layers", []))
    with torch.no_grad():
        for layer in layers:
            for w in (layer.mlp.w_up, layer.mlp.w_down):
                w.mul_(tpr.block_mask(w, 0.5, block=block))


@pytest.fixture(scope="module")
def smoke_params():
    """Per arch, computed once: JAX's ``init_model(PRNGKey(0))``
    parameters as numpy (a fresh copy per call)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            init = jax.jit(lambda key: jtfm.init_model(key, jsmoke(arch))[0])
            cache[arch] = jax.tree_util.tree_map(
                np.asarray, init(jax.random.PRNGKey(0)))
        return jax.tree_util.tree_map(np.array, cache[arch])
    return get


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ["nemotron-4-340b", "whisper-base"])
def test_pruned_forward_on_cached_plans_matches_jax(smoke_params, arch,
                                                    mode):
    """JAX runs its plain products (``use_kernel=False``: the same
    schedules and counts, no interpret-mode kernels); the port its
    kernels' plain versions."""
    whisper = arch == "whisper-base"
    jcfg = dataclasses.replace(jsmoke(arch), **MODES[mode])
    tcfg = dataclasses.replace(tsmoke(arch), **MODES[mode],
                               sparse_use_kernel=True)
    params = smoke_params(arch)
    model = convert.from_jax_params(params, tcfg, device="cpu")
    _prune_torch(model, tcfg)
    params = _prune_jax(params, jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 5)).astype(np.int32)
    jbatch, tbatch = {"tokens": jnp.asarray(tokens)}, {
        "tokens": torch.from_numpy(tokens).long()}
    if whisper:
        mel = np.maximum(rng.standard_normal(
            (2, 2 * tcfg.encoder_len, tcfg.n_mels)), 0).astype(np.float32)
        jbatch["mel"], tbatch["mel"] = jnp.asarray(mel), torch.from_numpy(mel)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    with jtape.collect() as je:
        jout = jtfm.forward(
            jparams, jbatch, jcfg, mode="prefill",
            rc=JRunConfig(act_dtype="float32", scan_unroll=True,
                          remat="none"),
            weight_plans=jtfm.plan_weight_activities(jparams, jcfg))
    plans = ttfm.plan_weight_activities(model, tcfg)
    with ttape.collect() as te:
        tout = model(tbatch, tcfg, rc=TRunConfig(act_dtype="float32"),
                     weight_plans=plans)
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               atol=1e-4, rtol=1e-4)
    strip = ("name", "dense_steps", "sparse_steps", "tiles_skipped")
    jsum, tsum = jtape.summarize(je), ttape.summarize(te)
    assert [[e[k] for k in strip] for e in tsum] == \
        [[e[k] for k in strip] for e in jsum]
    assert all(e["executed_steps"] == e["sparse_steps"] for e in tsum)
    for e in tsum:
        if e["name"] == "mlp.up":
            # half the tiles dropped; the activation skips the rest
            assert e["sparse_steps"] <= e["dense_steps"] // 2 + 1
