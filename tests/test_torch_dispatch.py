"""Dispatch parity: ``matmul``/``project`` in every mode, with and without
the kernels, agree with the JAX package's dispatch (Pallas in interpret
mode) within 1e-4 in f32, and the tapes' StepCounts are equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import activation as jact
from repro.sparse import dispatch as jdsp
from repro.sparse import tape as jtape
from repro.sparse import weights as jw
from repro_torch.sparse import activation as tact
from repro_torch.sparse import dispatch as tdsp
from repro_torch.sparse import tape as ttape
from repro_torch.sparse import weights as tw

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

CASES = [  # (mode, use_kernel, condense)
    ("dense", False, None),
    ("weight", False, None),
    ("weight", True, None),
    ("dual", False, None),
    ("dual", True, None),
    ("dual", False, "k"),
    ("dual", True, "k"),
]
GEOM = dict(block_m=8, block_n=16, slice_k=32)


def _weights(rng, k, n):
    w = rng.normal(size=(k, n)).astype(np.float32)
    w[:32] = 0                       # a dead k-slice
    w[:, 16:32] = 0                  # a dead block column: counts == 0
    w[rng.random((k, n)) < 0.3] = 0
    return w


def _run_jax(x, w, planned, kw):
    if planned:
        w = jw.plan_weight(w, slice_k=kw["slice_k"], block_n=kw["block_n"])
    with jtape.collect() as entries:
        y, _ = jdsp.matmul(x, w, interpret=True, name="t", **kw)
    return np.asarray(y), jtape.summarize(entries)


def _run_torch(x, w, planned, kw):
    if planned:
        w = tw.plan_weight(w, slice_k=kw["slice_k"], block_n=kw["block_n"])
    with ttape.collect() as entries:
        y, _ = tdsp.matmul(x, w, name="t", **kw)
    return y.numpy(), ttape.summarize(entries)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("planned", [False, True])
def test_matmul_parity(rng, case, planned):
    mode, use_kernel, condense = case
    h = rng.normal(size=(3, 7, 96)).astype(np.float32)
    w = _weights(rng, 96, 40)
    kw = dict(mode=mode, use_kernel=use_kernel, condense=condense, **GEOM)
    jx = jact.relu2(jnp.asarray(h), slice_k=32)
    tx = tact.relu2(torch.from_numpy(h), slice_k=32)
    jy, jsum = _run_jax(jx, jnp.asarray(w), planned, kw)
    ty, tsum = _run_torch(tx, torch.from_numpy(w), planned, kw)
    assert ty.shape == jy.shape == (3, 7, 40)
    np.testing.assert_allclose(ty, jy, atol=1e-4, rtol=1e-4)
    assert tsum == jsum
    if mode != "dense":
        assert tsum[0]["sparse_steps"] < tsum[0]["dense_steps"]


@pytest.mark.parametrize("case", [c for c in CASES if c[0] != "dense"])
def test_plain_operand_and_project(rng, case):
    """A plain (non-bitmap) activation plans from ``x != 0``; the
    attention head projections (n_contract 1 and 2) match JAX's."""
    mode, use_kernel, condense = case
    kw = dict(mode=mode, use_kernel=use_kernel, condense=condense, **GEOM)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    x[..., :20] = 0
    wq = _weights(rng, 48, 24).reshape(48, 4, 6)
    wo = _weights(rng, 24, 48).reshape(4, 6, 48)
    for xin, w, nc in ((x, wq, 1), (x.reshape(2, 5, 4, 12)[..., :6], wo, 2)):
        xin = np.ascontiguousarray(xin)
        with jtape.collect() as je:
            jy, _ = jdsp.project(jnp.asarray(xin), jnp.asarray(w),
                                 n_contract=nc, interpret=True, name="p",
                                 **kw)
        with ttape.collect() as te:
            ty, _ = tdsp.project(torch.from_numpy(xin), torch.from_numpy(w),
                                 n_contract=nc, name="p", **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                                   rtol=1e-4)
        assert ttape.summarize(te) == jtape.summarize(je)


def test_project_rejects_unknown_knob():
    with pytest.raises(TypeError, match="unknown dispatch knob"):
        tdsp.project(torch.zeros(2, 4), torch.zeros(4, 3), blockm=8)


def test_bf16_dual_kernels_match_dense(rng):
    """bf16 K1/K2 plain paths against the f32-accumulated oracle."""
    h = rng.normal(size=(16, 96)).astype(np.float32)
    w = _weights(rng, 96, 40)
    x = tact.relu2(torch.from_numpy(h).to(torch.bfloat16), slice_k=32)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    ref = x.values.float() @ wt.float()
    for condense in (None, "k"):
        y, _ = tdsp.matmul(x, wt, mode="dual", use_kernel=True,
                           condense=condense, **GEOM)
        assert y.dtype == torch.bfloat16
        np.testing.assert_allclose(y.float().numpy(), ref.numpy(),
                                   atol=2e-2, rtol=2e-2)
