"""Grouped parity: the port's per-problem schedules, K3/K4 plain versions
and ``dispatch.grouped_matmul`` against the JAX package.

Schedules (ks, gk, counts) are bit-equal.  f32 products agree within 1e-4
with the Pallas kernels in interpret mode, ragged problems (rows emptied
to ``counts == 0`` blocks, an all-empty problem) and odd M, N, K
included.  bf16 is held against ``kernels/ref.py::spgemm_ref`` per
problem within 2e-2, because the JAX bf16 kernels cannot run in
interpret mode on this JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import grouped_spgemm as jgsk
from repro.kernels import ref as jref
from repro.sparse import activation as jact
from repro.sparse import dispatch as jdsp
from repro.sparse import plan as jpln
from repro.sparse import tape as jtape
from repro.sparse import weights as jw
from repro_torch.kernels import grouped_spgemm as tgsk
from repro_torch.sparse import activation as tact
from repro_torch.sparse import dispatch as tdsp
from repro_torch.sparse import plan as tpln
from repro_torch.sparse import tape as ttape
from repro_torch.sparse import weights as tw

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

# (E, C, K, N, block_m, block_n, slice_k): odd C, K, N, partial slices
SHAPES = [
    (4, 24, 40, 20, 8, 8, 16),
    (4, 7, 13, 9, 8, 8, 16),
    (3, 33, 65, 17, 16, 8, 32),
    (5, 37, 200, 50, 16, 16, 32),
]
# occupied-row fraction of each problem: one all-empty, one partial
OCC = (1.0, 0.6, 0.0, 0.25, 0.9)


def _operands(rng, e, c, k, n, bn, sk):
    """Ragged (E, C, K) activations and block-pruned (E, K, N) weights."""
    a = rng.normal(size=(e, c, k)).astype(np.float32)
    a[rng.random(a.shape) < 0.1] = 0
    for i in range(e):
        a[i, int(round(c * OCC[i])):] = 0
    b = rng.normal(size=(e, k, n)).astype(np.float32)
    for i in range(e):                          # dead (slice, block) tiles
        for s0 in range(0, k, sk):
            for n0 in range(0, n, bn):
                if rng.random() < 0.4:
                    b[i, s0:s0 + sk, n0:n0 + bn] = 0
    return a, b


def _jax_plans(a, b, bm, bn, sk):
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ks, counts = jgsk.plan_grouped(ja, jb, bm, bn, sk)
    kp = jpln.plan_grouped_kcondensed(
        jax.vmap(lambda x: jpln.element_activity_lhs(x, bm))(ja),
        jax.vmap(lambda x: jpln.element_activity_rhs(x, bn))(jb), sk)
    return ks, counts, kp


def _torch_plans(a, b, bm, bn, sk):
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ks, counts = tpln.plan_grouped_activity(
        tpln.block_reduce_lhs(tpln.slice_activity_lhs(ta, sk), bm),
        tpln.block_reduce_rhs(tpln.slice_activity_rhs(tb, sk), bn))
    kp = tpln.plan_grouped_kcondensed(tpln.element_activity_lhs(ta, bm),
                                      tpln.element_activity_rhs(tb, bn), sk)
    return ks, counts, kp


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("shape", SHAPES)
def test_grouped_schedules_bit_equal(rng, shape):
    e, c, k, n, bm, bn, sk = shape
    a, b = _operands(rng, e, c, k, n, bn, sk)
    jks, jcounts, jkp = _jax_plans(a, b, bm, bn, sk)
    tks, tcounts, tkp = _torch_plans(a, b, bm, bn, sk)
    assert tks.dtype == tcounts.dtype == tkp.gk.dtype == torch.int32
    _eq(tks, jks)
    _eq(tcounts, jcounts)
    _eq(tkp.gk, jkp.gk)
    _eq(tkp.counts, jkp.counts)
    _eq(tkp.nnz, jkp.nnz)
    assert (tcounts[2] == 0).all() and (tkp.counts[2] == 0).all()
    # the schedule-free counts and the summed StepCounts agree too
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    cols = tpln.block_reduce_lhs(tpln.slice_activity_lhs(ta, sk), bm)
    rows = tpln.block_reduce_rhs(tpln.slice_activity_rhs(tb, sk), bn)
    _eq(tpln.grouped_counts_from_activity(cols, rows), jcounts)
    _eq(tpln.grouped_kcondensed_counts(tpln.element_activity_lhs(ta, bm),
                                       tpln.element_activity_rhs(tb, bn),
                                       sk), jkp.counts)
    tst = tpln.grouped_counts_to_steps(tcounts, tks.shape[-1])
    jst = jpln.grouped_counts_to_steps(jcounts, jks.shape[-1])
    assert [int(x) for x in tst] == [int(x) for x in jst]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_f32(rng, shape):
    e, c, k, n, bm, bn, sk = shape
    a, b = _operands(rng, e, c, k, n, bn, sk)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jks, jcounts, jkp = _jax_plans(a, b, bm, bn, sk)
    tks, tcounts, tkp = _torch_plans(a, b, bm, bn, sk)
    geom = dict(block_m=bm, block_n=bn, slice_k=sk)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    j3 = jgsk.grouped_spgemm_planned(ja, jb, jks, jcounts, interpret=True,
                                     **geom)
    t3 = tgsk.grouped_spgemm_planned(ta, tb, tks, tcounts, device="cpu",
                                     **geom)
    np.testing.assert_allclose(t3.numpy(), np.asarray(j3), atol=1e-4,
                               rtol=1e-4)
    j4 = jgsk.grouped_spgemm_kfused_planned(ja, jb, jkp.gk, jkp.counts,
                                            interpret=True, **geom)
    t4 = tgsk.grouped_spgemm_kfused_planned(ta, tb, tkp.gk, tkp.counts,
                                            device="cpu", **geom)
    np.testing.assert_allclose(t4.numpy(), np.asarray(j4), atol=1e-4,
                               rtol=1e-4)
    # the all-empty problem comes out as zeros, and the CPU path runs the
    # plain versions: no kernel launched
    assert not t3[2].any() and not t4[2].any()
    assert tgsk.grouped_spgemm_planned.launches == 0
    assert tgsk.grouped_spgemm_kfused_planned.launches == 0


@pytest.mark.parametrize("shape", SHAPES[2:])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_plain_bf16_matches_spgemm_ref(rng, shape, out_dtype):
    e, c, k, n, bm, bn, sk = shape
    a, b = _operands(rng, e, c, k, n, bn, sk)
    a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    b = np.array(jnp.asarray(b, jnp.bfloat16).astype(jnp.float32))
    tks, tcounts, tkp = _torch_plans(a, b, bm, bn, sk)
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    geom = dict(block_m=bm, block_n=bn, slice_k=sk, out_dtype=out_dtype,
                device="cpu")
    jout = None if out_dtype is None else jnp.float32
    ref = np.stack([np.asarray(jref.spgemm_ref(
        jnp.asarray(a[i], jnp.bfloat16), jnp.asarray(b[i], jnp.bfloat16),
        out_dtype=jout).astype(jnp.float32)) for i in range(e)])
    want = torch.bfloat16 if out_dtype is None else torch.float32
    for y in (tgsk.grouped_spgemm_planned(ta, tb, tks, tcounts, **geom),
              tgsk.grouped_spgemm_kfused_planned(ta, tb, tkp.gk, tkp.counts,
                                                 **geom)):
        assert y.dtype == want and tuple(y.shape) == (e, c, n)
        np.testing.assert_allclose(y.float().numpy(), ref, atol=2e-2,
                                   rtol=2e-2)


CASES = [  # (mode, use_kernel, condense)
    ("dense", False, None),
    ("weight", False, None),
    ("weight", True, None),
    ("dual", False, None),
    ("dual", True, None),
    ("dual", False, "k"),
    ("dual", True, "k"),
]
GEOM = dict(block_m=8, block_n=8, slice_k=16)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("operands", ["plain", "planned"])
def test_grouped_matmul_parity(rng, case, operands):
    """Plain tensors plan from values; a relu'd SparseActivation and a
    PlannedWeight plan from their metadata.  Outputs within 1e-4, tapes
    equal, executed == counted on the kernel arm."""
    mode, use_kernel, condense = case
    e, c, k, n = 4, 21, 40, 20
    a, b = _operands(rng, e, c, k, n, GEOM["block_n"], GEOM["slice_k"])
    kw = dict(mode=mode, use_kernel=use_kernel, condense=condense, **GEOM)
    if operands == "planned":
        jx = jact.relu(jnp.asarray(a), slice_k=16)
        tx = tact.relu(torch.from_numpy(a), slice_k=16)
        jwt = jw.plan_weight(jnp.asarray(b), slice_k=16, block_n=8)
        twt = tw.plan_weight(torch.from_numpy(b), slice_k=16, block_n=8)
    else:
        jx, tx = jnp.asarray(a), torch.from_numpy(a)
        jwt, twt = jnp.asarray(b), torch.from_numpy(b)
    with jtape.collect() as je:
        jy, _ = jdsp.grouped_matmul(jx, jwt, interpret=True, name="g", **kw)
    with ttape.collect() as te:
        ty, _ = tdsp.grouped_matmul(tx, twt, name="g", **kw)
    assert tuple(ty.shape) == (e, c, n)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    tsum, jsum = ttape.summarize(te), jtape.summarize(je)
    assert tsum == jsum
    if mode != "dense":
        assert tsum[0]["sparse_steps"] < tsum[0]["dense_steps"]
    if use_kernel:
        assert tsum[0]["executed_steps"] == tsum[0]["sparse_steps"]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_grouped_matmul_out_dtype(rng, use_kernel):
    """bf16 operands with a float32 output, as the decode attention
    sites ask for: f32 accumulation of exact bf16 products."""
    a, b = _operands(rng, 3, 9, 40, 12, 8, 16)
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    y, _ = tdsp.grouped_matmul(ta, tb, mode="dual", use_kernel=use_kernel,
                               out_dtype=torch.float32, **GEOM)
    jy = jnp.einsum("eck,ekn->ecn", jnp.asarray(ta.float().numpy()),
                    jnp.asarray(tb.float().numpy()))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)


def test_grouped_matmul_rejects_2d():
    with pytest.raises(ValueError, match="grouped_matmul expects"):
        tdsp.grouped_matmul(torch.zeros(4, 8), torch.zeros(8, 3))
