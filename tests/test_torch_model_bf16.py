"""bf16 model parity: the port's bf16 ``forward`` of the JAX parameters
matches the JAX bf16 ``forward`` within 2e-2 in dense, dual (K1) and
dual+kcondense (K2), with the same counted schedules.

The JAX bf16 K2 cannot run here (its own bf16 parity tests fail), so the
JAX side of dual+kcondense is its matmul arm: the same element-granular
schedule is counted, and the product is the same function."""
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
from repro_torch.sparse import tape as ttape

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

ARCH = "nemotron-4-340b"
MODES = {  # mode: (port knobs, JAX knobs)
    "dense": (dict(), dict()),
    "dual": (dict(sparse_mode="dual", sparse_use_kernel=True),
             dict(sparse_mode="dual", sparse_use_kernel=True)),
    "dual+kc": (dict(sparse_mode="dual", sparse_use_kernel=True,
                     sparse_kcondense=True),
                dict(sparse_mode="dual", sparse_kcondense=True)),
}


@pytest.fixture(scope="module")
def params():
    p, _ = jtfm.init_model(jax.random.PRNGKey(0), jsmoke(ARCH))
    p = jax.tree_util.tree_map(lambda a: np.array(a), p)
    p["layers"]["pos0"]["mlp"]["w_up"][:, :, :128] = 0
    p["lm_head"][:, :128] = 0
    return p


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_bf16(params, mode):
    tkw, jkw = MODES[mode]
    tokens = np.random.default_rng(0).integers(0, 512, (2, 7)).astype(
        np.int32)
    jcfg = dataclasses.replace(jsmoke(ARCH), **jkw)
    tcfg = dataclasses.replace(tsmoke(ARCH), **tkw)
    with jtape.collect() as je:
        jout = jtfm.forward(params, {"tokens": tokens}, jcfg, mode="prefill",
                            rc=JRunConfig(act_dtype="bfloat16",
                                          scan_unroll=True))
    model = convert.from_jax_params(params, tcfg, device="cpu",
                                    dtype=torch.bfloat16)
    with ttape.collect() as te:
        tout = model({"tokens": torch.from_numpy(tokens).long()}, tcfg)
    assert tout.logits.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.logits.float().numpy(),
                               np.asarray(jout.logits.astype(np.float32)),
                               atol=2e-2, rtol=2e-2)
    key = [(e["name"], e["dense_steps"], e["sparse_steps"])
           for e in jtape.summarize(je)]
    assert [(e["name"], e["dense_steps"], e["sparse_steps"])
            for e in ttape.summarize(te)] == key
