"""The paper's SpGEMM API in the port against the JAX package, on the same
numpy operands (CPU; the kernels' plain walks).

* ``sparse.plan.plan_operands`` and ``kernels.bitmap_spgemm.plan_slices``:
  ``ks``/``counts`` bit-equal;
* the on-the-fly entries: ``bitmap_spgemm`` (K1) against the JAX
  interpret-mode kernel within 1e-4 (float32);
  ``bitmap_spgemm_kfused`` (K2) and ``bitmap_spgemm_kcondensed`` against
  ``kernels/ref.spgemm_ref`` within 2e-2 in bf16 (the JAX bf16 K2 parity
  fails in the reference itself); ``kcondense`` bit-equal;
* ``core/spgemm.py``: ``outer_step``, ``merge_partial``,
  ``spgemm_emulate`` and ``plan_blocks`` equal to JAX's; ``spgemm``'s
  StepCounts bit-equal, its product within 1e-4;
* ``kernels/ops.bitmap_encode`` and ``kernels/ref.encode_ref`` bit-equal
  to JAX's ``encode_ref``; the entry points' device default.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as jbm
from repro.core import spgemm as jsg
from repro.kernels import bitmap_spgemm as jbs
from repro.kernels import ref as jref
from repro.sparse import plan as jpln
from repro_torch.core import bitmap as tbm
from repro_torch.core import spgemm as tsg
from repro_torch.kernels import bitmap_spgemm as tbs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.sparse import plan as tpln

torch.set_num_threads(1)


def _sparse(rng, shape, density):
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.random(shape) >= density] = 0
    return x


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


GEOMS = [  # (M, K, N, block_m, block_n, slice_k)
    (64, 128, 64, 32, 32, 32),
    (56, 120, 40, 32, 32, 32),       # ragged edges, a partial last slice
    (8, 32, 8, 8, 8, 8),
    (40, 300, 72, 16, 64, 128),
]


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("density", [0.1, 0.5])
def test_plan_operands_and_plan_slices_match_jax(geom, density):
    m, k, n, bm, bn, sk = geom
    rng = np.random.default_rng(1)
    a, b = _sparse(rng, (m, k), density), _sparse(rng, (k, n), density)
    a[: m // 2, : k // 2] = 0                  # whole empty slices
    jks, jc = jpln.plan_operands(jnp.asarray(a), jnp.asarray(b), bm, bn, sk)
    tks, tc = tpln.plan_operands(torch.from_numpy(a), torch.from_numpy(b),
                                 bm, bn, sk)
    _eq(tks, jks)
    _eq(tc, jc)
    jks, jc = jbs.plan_slices(jnp.asarray(a), jnp.asarray(b), bm, bn, sk)
    tks, tc = tbs.plan_slices(torch.from_numpy(a), torch.from_numpy(b), bm,
                              bn, sk)
    assert tks.dtype == tc.dtype == torch.int32
    _eq(tks, jks)
    _eq(tc, jc)


@pytest.mark.parametrize("geom", GEOMS)
def test_bitmap_spgemm_matches_jax_interpret(geom):
    m, k, n, bm, bn, sk = geom
    rng = np.random.default_rng(2)
    a, b = _sparse(rng, (m, k), 0.4), _sparse(rng, (k, n), 0.5)
    j = jbs.bitmap_spgemm(jnp.asarray(a), jnp.asarray(b), block_m=bm,
                          block_n=bn, slice_k=sk, interpret=True)
    t = tbs.bitmap_spgemm(torch.from_numpy(a), torch.from_numpy(b),
                          block_m=bm, block_n=bn, slice_k=sk, device="cpu")
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(j)).max())
    # the re-export is the same entry
    assert tops.bitmap_spgemm is tbs.bitmap_spgemm


@pytest.mark.parametrize("geom", GEOMS[:2] + [(48, 200, 24, 256, 256, 128)])
@pytest.mark.parametrize("density", [0.3, 0.9])
def test_kfused_and_kcondensed_bf16_against_spgemm_ref(geom, density):
    m, k, n, bm, bn, sk = geom
    rng = np.random.default_rng(3)
    a, b = _sparse(rng, (m, k), density), _sparse(rng, (k, n), density)
    a[:, ::3] = 0                                # k-fibers dead in A only
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    ref = np.asarray(jref.spgemm_ref(jnp.asarray(ta.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(tb.float().numpy()).astype(jnp.bfloat16),
        out_dtype=jnp.float32))
    tol = 2e-2 * np.abs(ref).max()
    np.testing.assert_allclose(
        tref.spgemm_ref(ta, tb, out_dtype=torch.float32).numpy(), ref,
        rtol=0, atol=1e-6 * np.abs(ref).max())
    for fn in (tbs.bitmap_spgemm_kfused, tbs.bitmap_spgemm_kcondensed):
        out = fn(ta, tb, block_m=bm, block_n=bn, slice_k=sk, device="cpu")
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                                   atol=tol)


def test_kcondense_matches_jax():
    rng = np.random.default_rng(4)
    a, b = _sparse(rng, (24, 100), 0.5), _sparse(rng, (100, 40), 0.5)
    a[:, 10:30] = 0
    b[50:70] = 0
    ja, jb_, jn = jbs.kcondense(jnp.asarray(a), jnp.asarray(b))
    ta, tb, tn = tbs.kcondense(torch.from_numpy(a), torch.from_numpy(b))
    _eq(ta, ja)
    _eq(tb, jb_)
    assert int(tn) == int(jn) == int(((a != 0).any(0) & (b != 0).any(1)).sum())
    np.testing.assert_allclose((ta @ tb).numpy(), a @ b, rtol=1e-5,
                               atol=1e-5)


def test_outer_step_merge_and_emulate_match_jax():
    rng = np.random.default_rng(5)
    a, b = _sparse(rng, (64, 16), 0.4), _sparse(rng, (16, 96), 0.4)
    ja, jb_ = jbm.encode(jnp.asarray(a), "col"), jbm.encode(jnp.asarray(b),
                                                            "row")
    ta, tb = tbm.encode(torch.from_numpy(a), "col"), tbm.encode(
        torch.from_numpy(b), "row")
    acc_np = rng.normal(size=(64, 96)).astype(np.float32)
    jacc, tacc = jnp.asarray(acc_np), torch.from_numpy(acc_np)
    for kk in (0, 7, 15):
        jp = jsg.outer_step(jnp.asarray(a[:, kk]), jnp.asarray(b[kk]),
                            ja.bitmap[:, kk], jb_.bitmap[kk])
        tp = tsg.outer_step(torch.from_numpy(a[:, kk]),
                            torch.from_numpy(b[kk]), ta.bitmap[:, kk],
                            tb.bitmap[kk])
        _eq(tp.values, jp.values)
        np.testing.assert_array_equal(_words(tp.bitmap), np.asarray(jp.bitmap))
        jacc, tacc = jsg.merge_partial(jacc, jp), tsg.merge_partial(tacc, tp)
        _eq(tacc, jacc)
    j = jsg.spgemm_emulate(jnp.asarray(a), jnp.asarray(b))
    t = tsg.spgemm_emulate(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), a @ b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cap", [None, 2])
def test_plan_blocks_matches_jax(cap):
    rng = np.random.default_rng(6)
    at, bt = rng.random((5, 7)) < 0.5, rng.random((7, 4)) < 0.5
    ji, jc = jsg.plan_blocks(jnp.asarray(at), jnp.asarray(bt), cap)
    ti, tc = tsg.plan_blocks(torch.from_numpy(at), torch.from_numpy(bt), cap)
    _eq(ti, ji)
    _eq(tc, jc)


@pytest.mark.parametrize("shape", [(300, 520, 200), (64, 1000, 96)])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_core_spgemm_steps_and_output_match_jax(shape, use_kernel):
    m, k, n = shape
    rng = np.random.default_rng(7)
    a, b = _sparse(rng, (m, k), 0.3), _sparse(rng, (k, n), 0.5)
    a[:256, :256] = 0
    b[256:512] = 0
    j = jsg.spgemm(jnp.asarray(a), jnp.asarray(b), use_kernel=False)
    t = tsg.spgemm(torch.from_numpy(a), torch.from_numpy(b),
                   use_kernel=use_kernel, device="cpu")
    assert tuple(int(v) for v in t.steps) == tuple(int(v) for v in j.steps)
    np.testing.assert_allclose(t.out.numpy(), np.asarray(j.out), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(j.out)).max())


def test_bitmap_encode_and_encode_ref_match_jax():
    rng = np.random.default_rng(8)
    x = _sparse(rng, (3, 5, 70), 0.3)
    jbits, jcond, jcounts, jcol = jref.encode_ref(jnp.asarray(x[0]), 32)
    tbits, tcond, tcounts, tcol = tref.encode_ref(torch.from_numpy(x[0]), 32)
    np.testing.assert_array_equal(_words(tbits), np.asarray(jbits))
    _eq(tcond, jcond)
    _eq(tcounts, jcounts)
    _eq(tcol, jcol)
    bits, cond = tops.bitmap_encode(torch.from_numpy(x), device="cpu")
    assert bits.shape == (3, 5, 3) and cond.shape == x.shape
    for c in range(3):
        rb, rc, _, _ = jref.encode_ref(jnp.asarray(x[c].reshape(5, 70)))
        np.testing.assert_array_equal(_words(bits[c]), np.asarray(rb))
        _eq(cond[c], rc)


def test_on_the_fly_entries_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None rightly runs on it")
    z = torch.zeros(16, 16)
    for fn in (tbs.bitmap_spgemm, tbs.bitmap_spgemm_kfused,
               tbs.bitmap_spgemm_kcondensed, tops.bitmap_spgemm):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(z, z)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsg.spgemm(z, z)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.bitmap_encode(z[None])
    # tensors on another device than the one asked for are refused
    with pytest.raises(ValueError, match="lies on cpu"):
        tbs.bitmap_spgemm(z, z, device="meta")
