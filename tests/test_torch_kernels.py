"""K1/K2 plain versions against the JAX package's Pallas kernels.

The same schedules (built by the JAX planner) go through the Pallas
kernels in interpret mode and through the port's wrappers on CPU tensors,
which run the plain versions.  f32 agrees within 1e-4.  bf16 is held
against ``kernels/ref.py::spgemm_ref`` (f32 accumulation) within 2e-2,
because the JAX bf16 K2 fails its own parity.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitmap_spgemm as jbsk
from repro.kernels import ref as jref
from repro.sparse import plan as jpln
from repro_torch.kernels import bitmap_spgemm as tbsk
from repro_torch.kernels import ref as tref

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

# (M, K, N, block_m, block_n, slice_k); ragged edges and partial slices
SHAPES = [
    (37, 200, 50, 16, 16, 32),
    (2, 130, 24, 8, 8, 64),
    (20, 96, 40, 8, 16, 96),
]


def _operands(rng, m, k, n, bn, dtype):
    """relu2-style activation zeros and block-pruned weights, so that some
    blocks have counts == 0 and some slices are partial."""
    h = rng.normal(size=(m, k)).astype(np.float32)
    a = np.square(np.maximum(h, 0))
    b = rng.normal(size=(k, n)).astype(np.float32)
    b[:, :bn] = 0                              # a dead block column
    b[rng.random((k, n)) < 0.5] = 0
    if dtype == "bfloat16":                   # representable in bf16
        a = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        b = np.asarray(jnp.asarray(b, jnp.bfloat16).astype(jnp.float32))
    return a, b


def _schedules(a, b, bm, bn, sk):
    col = jpln.block_reduce_lhs(jpln.slice_activity_lhs(a, sk), bm)
    row = jpln.block_reduce_rhs(jpln.slice_activity_rhs(b, sk), bn)
    ks, counts = jpln.plan_from_activity(col, row)
    kp = jpln.plan_kcondensed(jpln.element_activity_lhs(a, bm),
                              jpln.element_activity_rhs(b, bn), sk)
    return ks, counts, kp


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_f32(rng, shape):
    m, k, n, bm, bn, sk = shape
    a, b = _operands(rng, m, k, n, bn, "float32")
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ks, counts, kp = _schedules(ja, jb, bm, bn, sk)
    assert int(jnp.sum(counts == 0)) > 0 and int(jnp.sum(kp.counts == 0)) > 0
    geom = dict(block_m=bm, block_n=bn, slice_k=sk)

    j1 = jbsk.bitmap_spgemm_planned(ja, jb, ks, counts, interpret=True,
                                    **geom)
    t1 = tbsk.bitmap_spgemm_planned(_t(a), _t(b), _t(ks), _t(counts),
                                    device="cpu", **geom)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), atol=1e-4,
                               rtol=1e-4)
    j2 = jbsk.bitmap_spgemm_kfused_planned(ja, jb, kp.gk, kp.counts,
                                           interpret=True, **geom)
    t2 = tbsk.bitmap_spgemm_kfused_planned(_t(a), _t(b), _t(kp.gk),
                                           _t(kp.counts), device="cpu",
                                           **geom)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), atol=1e-4,
                               rtol=1e-4)
    # the CPU path runs the plain versions and launches no kernel
    assert tbsk.bitmap_spgemm_planned.launches == 0
    assert tbsk.bitmap_spgemm_kfused_planned.launches == 0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_plain_bf16_matches_spgemm_ref(rng, shape, out_dtype):
    m, k, n, bm, bn, sk = shape
    a, b = _operands(rng, m, k, n, bn, "bfloat16")
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    ks, counts, kp = _schedules(ja, jb, bm, bn, sk)
    jout = None if out_dtype is None else jnp.float32
    ref = np.asarray(jref.spgemm_ref(ja, jb, out_dtype=jout)
                     .astype(jnp.float32))
    ta, tb = _t(a, torch.bfloat16), _t(b, torch.bfloat16)
    geom = dict(block_m=bm, block_n=bn, slice_k=sk, out_dtype=out_dtype,
                device="cpu")
    want = torch.bfloat16 if out_dtype is None else torch.float32
    for y in (tbsk.bitmap_spgemm_planned(ta, tb, _t(ks), _t(counts), **geom),
              tbsk.bitmap_spgemm_kfused_planned(ta, tb, _t(kp.gk),
                                                _t(kp.counts), **geom)):
        assert y.dtype == want
        np.testing.assert_allclose(y.float().numpy(), ref, atol=2e-2,
                                   rtol=2e-2)
    # the port's own oracle agrees with the JAX one
    np.testing.assert_allclose(
        tref.spgemm_ref(ta, tb, out_dtype=out_dtype).float().numpy(), ref,
        atol=2e-2, rtol=2e-2)


def test_wrapper_rejects_bad_schedules(rng):
    a = torch.zeros(10, 20)
    b = torch.zeros(20, 30)
    ks = torch.zeros(1, 2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not cover"):
        tbsk.bitmap_spgemm_planned(a, b, ks, torch.zeros(1, 2,
                                                         dtype=torch.int32),
                                   block_m=8, block_n=16, slice_k=8,
                                   device="cpu")
    with pytest.raises(ValueError, match="counts"):
        tbsk.bitmap_spgemm_planned(a, b, ks, torch.zeros(2, 2,
                                                         dtype=torch.int32),
                                   block_m=10, block_n=16, slice_k=8,
                                   device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        tbsk.bitmap_spgemm_kfused_planned(
            a, b, torch.zeros(1, 2, 3, 4, dtype=torch.int32),
            torch.zeros(1, 2, dtype=torch.int32), block_m=10, block_n=16,
            slice_k=8, device="cpu")
