"""Planner parity: repro_torch's bitmaps and schedules equal the JAX
package's bit for bit (packed words, ks, gk, counts, StepCounts)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as jbm
from repro.sparse import activation as jact
from repro.sparse import plan as jpln
from repro_torch.core import bitmap as tbm
from repro_torch.sparse import activation as tact
from repro_torch.sparse import plan as tpln

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

# (M, K, N, block_m, block_n, slice_k): ragged M/N/K included
SHAPES = [
    (5, 20, 12, 8, 8, 8),
    (37, 200, 50, 16, 16, 32),
    (64, 384, 96, 64, 32, 128),
    (3, 130, 9, 8, 8, 128),
    (16, 96, 256, 8, 128, 96),
]


def _sparse(rng, shape, density):
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.random(shape) >= density] = 0
    return x


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 96), (7, 32)])
def test_pack_unpack_popcount(rng, shape):
    mask = rng.random(shape) < 0.4
    words = tbm.pack_bits(torch.from_numpy(mask))
    jwords = np.asarray(jbm.pack_bits(jnp.asarray(mask)))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jwords)
    _eq(tbm.unpack_bits(words), mask)
    _eq(tbm.popcount(words), jbm.popcount(jnp.asarray(jwords)))
    # the other axis too
    m2 = np.moveaxis(mask, -1, 0)
    np.testing.assert_array_equal(
        tbm.pack_bits(torch.from_numpy(m2), axis=0).numpy().view(np.uint32),
        np.asarray(jbm.pack_bits(jnp.asarray(m2), axis=0)))


@pytest.mark.parametrize("k", [1, 31, 33, 100])
def test_pack_bits_padded(rng, k):
    mask = rng.random((4, k)) < 0.5
    np.testing.assert_array_equal(
        tbm.pack_bits_padded(torch.from_numpy(mask)).numpy().view(np.uint32),
        np.asarray(jbm.pack_bits_padded(jnp.asarray(mask))))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_plans(a, b, bm, bn, sk):
    """Every JAX planner output of one problem, in one compiled call."""
    out = dict(sa_l=jpln.slice_activity_lhs(a, sk),
               sa_r=jpln.slice_activity_rhs(b, sk))
    out["col"] = jpln.block_reduce_lhs(out["sa_l"], bm)
    out["row"] = jpln.block_reduce_rhs(out["sa_r"], bn)
    out["ks"], out["counts"] = jpln.plan_from_activity(out["col"], out["row"])
    out["counts_only"] = jpln.counts_from_activity(out["col"], out["row"])
    out["steps"] = jpln.counts_to_steps(out["counts"], out["ks"].shape[-1])
    out["ecol"] = jpln.element_activity_lhs(a, bm)
    out["erow"] = jpln.element_activity_rhs(b, bn)
    kp = jpln.plan_kcondensed(out["ecol"], out["erow"], sk)
    out["gk"], out["kcounts"], out["nnz"] = kp.gk, kp.counts, kp.nnz
    out["kcounts_only"] = jpln.kcondensed_counts(out["ecol"], out["erow"], sk)
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("density", [0.05, 0.5])
def test_schedules_match(rng, shape, density):
    m, k, n, bm, bn, sk = shape
    a = _sparse(rng, (m, k), density)
    b = _sparse(rng, (k, n), density)
    b[:, :min(bn, n)] = 0            # a block column with counts == 0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    j = _jax_plans(jnp.asarray(a), jnp.asarray(b), bm, bn, sk)

    _eq(tpln.slice_activity_lhs(ta, sk), j["sa_l"])
    _eq(tpln.slice_activity_rhs(tb, sk), j["sa_r"])
    col = tpln.block_reduce_lhs(tpln.slice_activity_lhs(ta, sk), bm)
    row = tpln.block_reduce_rhs(tpln.slice_activity_rhs(tb, sk), bn)
    _eq(col, j["col"])
    _eq(row, j["row"])

    ks, counts = tpln.plan_from_activity(col, row)
    assert ks.dtype == counts.dtype == torch.int32
    _eq(ks, j["ks"])
    _eq(counts, j["counts"])
    assert (counts == 0).any()
    _eq(tpln.counts_from_activity(col, row), j["counts_only"])
    st = tpln.counts_to_steps(counts, ks.shape[-1])
    assert [int(v) for v in st] == [int(v) for v in j["steps"]]

    ecol = tpln.element_activity_lhs(ta, bm)
    erow = tpln.element_activity_rhs(tb, bn)
    _eq(ecol, j["ecol"])
    _eq(erow, j["erow"])
    kp = tpln.plan_kcondensed(ecol, erow, sk)
    assert kp.gk.dtype == kp.counts.dtype == torch.int32
    _eq(kp.gk, j["gk"])
    _eq(kp.counts, j["kcounts"])
    _eq(kp.nnz, j["nnz"])
    _eq(tpln.kcondensed_counts(ecol, erow, sk), j["kcounts_only"])


@pytest.mark.parametrize("s", [1, 7, 40])
def test_stable_partition_and_front_pack(rng, s):
    act = rng.random((3, 5, s)) < 0.3
    act[0, 0] = False                      # an empty fiber
    order, counts = tpln.stable_partition(torch.from_numpy(act))
    jorder, jcounts = jpln.stable_partition(jnp.asarray(act))
    _eq(order, jorder)
    _eq(counts, jcounts)
    idx, cnt = tpln.front_pack(torch.from_numpy(act))
    jidx, jcnt = jpln.front_pack(jnp.asarray(act))
    _eq(idx, jidx)
    _eq(cnt, jcnt)


@pytest.mark.parametrize("kind", ["relu", "relu2"])
def test_sparse_activation_metadata(rng, kind):
    h = rng.normal(size=(2, 3, 200)).astype(np.float32)
    t = tact.activate(torch.from_numpy(h), kind, slice_k=64)
    j = jact.activate(jnp.asarray(h), None, kind, slice_k=64)
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(t.bitmap.numpy().view(np.uint32),
                                  np.asarray(j.bitmap))
    _eq(t.slice_act, j.slice_act)
    _eq(t.element_mask(), j.element_mask())
    _eq(t.row_slice_activity(32), j.row_slice_activity(32))


@pytest.mark.parametrize("mnk", [(2, 73728, 18432), (64, 18432, 256000),
                                 (5, 3, 20), (200, 50, 7)])
def test_clamp_geometry_matches_interpret_rule(mnk):
    m, n, k = mnk
    for knobs in ((128, 128, 128), (256, 64, 32)):
        assert tpln.clamp_geometry(m, n, k, *knobs) == \
            jpln.clamp_geometry(m, n, k, *knobs, interpret=True)
    assert tpln.effective_slice_k(k, 128) == jpln.effective_slice_k(k, 128)
