"""K3/K4's routes on the CPU: the rule that picks each product's CUDA
kernel, the splits it gives, and the float32 x bfloat16 pair the decode
value hands the grouped kernels (V as stored).

The plain walks upcast both operands to float32, so the mixed pair must
give the same bits as the walk of the float32 cast.  The grouped dispatch
on the value pair, with and without the kernel arm, must equal the JAX
package's ``grouped_matmul`` (which casts V to float32) within 1e-4, with
bit-equal tape step counts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import dispatch as jdsp
from repro.sparse import kvcache as jskv
from repro.sparse import tape as jtape
from repro_torch.kernels import bitmap_spgemm as bsk
from repro_torch.kernels import grouped_spgemm as tgsk
from repro_torch.sparse import dispatch as tdsp
from repro_torch.sparse import kvcache as tskv
from repro_torch.sparse import plan as tpln
from repro_torch.sparse import tape as ttape

torch.set_num_threads(1)

H100_SMS = 132
K3, K4 = bsk.GROUPED_SOURCES
K1, K2 = "bitmap_spgemm.cu", "bitmap_spgemm_kfused.cu"
F32, BF16 = torch.float32, torch.bfloat16


def _bf16_grid(rng, shape):
    """Normal values that bf16 holds exactly."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.to(BF16)


def _value_case(rng, e, g, t, hd, written, bt):
    """The decode value's operands as ``attend_sparse`` builds them:
    float32 probabilities p (E, G, T) zero past ``written`` slots, V
    (E, T, hd) in bf16, written slots occupied, block_t ``bt``."""
    p = rng.random((e, g, t)).astype(np.float32)
    p[..., written:] = 0
    v = _bf16_grid(rng, (e, t, hd))
    v[:, written:] = 0
    occ = np.arange(t) < written
    return p, v, occ


@pytest.mark.parametrize("shape", [
    # (E, C, K, N, block_m, block_n, slice_k)
    (4, 12, 96, 24, 12, 16, 16),        # the value's layout, small
    (5, 37, 200, 50, 16, 16, 32),       # ragged, partial slices
])
@pytest.mark.parametrize("out_dtype", [None, F32, BF16])
def test_mixed_plain_walks_equal_the_cast_walks(rng, shape, out_dtype):
    e, c, k, n, bm, bn, sk = shape
    a = torch.from_numpy(rng.normal(size=(e, c, k)).astype(np.float32))
    a[1, :, k // 3:] = 0
    a[2] = 0                                            # an empty problem
    b = _bf16_grid(rng, (e, k, n))
    bm, bn, sk = tpln.clamp_geometry(c, n, k, bm, bn, sk)
    cols = tpln.block_reduce_lhs(tpln.slice_activity_lhs(a, sk), bm)
    rows = tpln.block_reduce_rhs(tpln.slice_activity_rhs(b, sk), bn)
    ks, counts = tpln.plan_grouped_activity(cols, rows)
    kp = tpln.plan_grouped_kcondensed(tpln.element_activity_lhs(a, bm),
                                      tpln.element_activity_rhs(b, bn), sk)
    geom = dict(block_m=bm, block_n=bn, slice_k=sk, out_dtype=out_dtype,
                device="cpu")
    for kern, sched, cnt in ((tgsk.grouped_spgemm_planned, ks, counts),
                             (tgsk.grouped_spgemm_kfused_planned, kp.gk,
                              kp.counts)):
        mixed = kern(a, b, sched, cnt, **geom)
        cast = kern(a, b.float(), sched, cnt, **geom)
        assert mixed.dtype == cast.dtype == (out_dtype or F32)
        assert torch.equal(mixed, cast)
        assert not mixed[2].any()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("condense", [None, "k"])
def test_value_pair_dispatch_matches_jax(rng, use_kernel, condense):
    """p (float32) @ V (bf16 PlannedWeight) through the grouped dispatch,
    against the JAX package's, which casts V to float32."""
    e, g, t, hd, written, bt = 4, 3, 64, 16, 21, 8
    p, v, occ = _value_case(rng, e, g, t, hd, written, bt)
    sched = occ.copy()
    kw = dict(mode="dual", use_kernel=use_kernel, condense=condense,
              block_m=8, block_n=8, slice_k=bt, name="attn.value")
    jx, jw = jskv.value_operands(jnp.asarray(occ), jnp.asarray(p),
                                 jnp.asarray(v.float().numpy(), jnp.bfloat16),
                                 jnp.asarray(sched), bt)
    tx, tw = tskv.value_operands(torch.from_numpy(occ), torch.from_numpy(p),
                                 v, torch.from_numpy(sched), bt)
    assert tx.values.dtype == F32 and tw.w.dtype == BF16
    with jtape.collect() as je:
        jy, _ = jdsp.grouped_matmul(jx, jw, interpret=True,
                                    out_dtype=jnp.float32, **kw)
    with ttape.collect() as te:
        ty, _ = tdsp.grouped_matmul(tx, tw, out_dtype=F32, **kw)
    assert ty.dtype == F32 and tuple(ty.shape) == (e, g, hd)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    tsum, jsum = ttape.summarize(te), jtape.summarize(je)
    assert tsum == jsum
    assert tsum[0]["sparse_steps"] < tsum[0]["dense_steps"]
    if use_kernel:
        assert tsum[0]["executed_steps"] == tsum[0]["sparse_steps"]


def test_value_dispatch_hands_the_kernel_v_as_stored(rng, monkeypatch):
    """On the kernel arm the grouped wrapper gets V in bf16 (no float32
    copy); without the kernel, and for a 2-D product, the weight is cast
    to the activation's type as before."""
    seen = []
    for name in ("grouped_spgemm_planned", "grouped_spgemm_kfused_planned"):
        kern = getattr(tgsk, name)

        def spy(a, b, *args, _kern=kern, **kw):
            seen.append((a.dtype, b.dtype))
            return _kern(a, b, *args, **kw)
        monkeypatch.setattr(tgsk, name, spy)
    p, v, occ = _value_case(rng, 2, 3, 32, 8, 11, 8)
    tx, tw = tskv.value_operands(torch.from_numpy(occ), torch.from_numpy(p),
                                 v, torch.from_numpy(occ), 8)
    for condense in (None, "k"):
        tdsp.grouped_matmul(tx, tw, mode="dual", use_kernel=True,
                            condense=condense, block_m=8, block_n=8,
                            slice_k=8, out_dtype=F32)
    assert seen == [(F32, BF16), (F32, BF16)]
    y, _ = tdsp.grouped_matmul(tx, tw, mode="dual", block_m=8, block_n=8,
                               slice_k=8, out_dtype=F32)
    assert y.dtype == F32 and len(seen) == 2


@pytest.mark.parametrize("src,a_dtype,b_dtype,n,k,want", [
    # the served decode attention: score bf16 at N = G = 12, K = hd = 192;
    # value float32 p against bf16 V
    (K3, BF16, BF16, 12, 192, "narrow"),
    (K4, BF16, BF16, 12, 192, "narrow"),
    (K3, F32, BF16, 192, 4096, "mixed"),
    (K4, F32, BF16, 192, 4096, "mixed"),
    # the narrow kernel's edges: N up to 16, B staged whole up to K 2048
    (K3, BF16, BF16, 1, 8, "narrow"),
    (K3, BF16, BF16, 16, 2048, "narrow"),
    (K3, BF16, BF16, 17, 192, "mma"),
    (K4, BF16, BF16, 12, 2049, "mma"),
    (K3, BF16, BF16, 192, 4096, "mma"),
    (K3, F32, F32, 12, 192, "simt"),
    (K4, F32, F32, 50, 200, "simt"),
    # K1/K2 keep their two routes, narrow N included
    (K1, BF16, BF16, 12, 192, "mma"),
    (K2, BF16, BF16, 1536, 18432, "mma"),
    (K1, F32, F32, 12, 192, "simt"),
])
def test_route_rule(src, a_dtype, b_dtype, n, k, want):
    assert bsk.route(src, a_dtype, b_dtype, n, k) == want


@pytest.mark.parametrize("src,a_dtype,b_dtype", [
    (K1, F32, BF16),                    # the mixed pair is K3/K4's only
    (K2, F32, BF16),
    (K3, BF16, F32),                    # and only one way round
    (K4, torch.float16, torch.float16),
    (K3, F32, torch.float16),
])
def test_route_rule_refuses(src, a_dtype, b_dtype):
    with pytest.raises(TypeError, match="kernel takes"):
        bsk.route(src, a_dtype, b_dtype, 12, 192)


@pytest.mark.parametrize("shape,dtypes,want_route,want_splits", [
    # (E, M, K, N, block_m, block_n, slice_k) as the sites clamp them
    ((16, 4096, 192, 12, 32, 12, 128), (BF16, BF16), "narrow", 1),
    ((16, 12, 4096, 192, 12, 128, 32), (F32, BF16), "mixed", 1),
    # the bf16 value (32 tiles of 128 columns, 128 steps) splits
    ((16, 12, 4096, 192, 12, 128, 32), (BF16, BF16), "mma", 16),
    ((16, 12, 4096, 192, 12, 128, 32), (F32, F32), "simt", 1),
    # ragged: too few steps a share to split
    ((5, 37, 200, 50, 16, 16, 32), (BF16, BF16), "mma", 1),
    ((5, 37, 200, 50, 16, 16, 32), (F32, BF16), "mixed", 1),
    # whisper-base's 6000-row shapes (E = 1) never split
    ((1, 6000, 512, 512, 128, 128, 128), (BF16, BF16), "mma", 1),
])
def test_grouped_splits_at_served_shapes(shape, dtypes, want_route,
                                         want_splits):
    e, m, k, n, bm, bn, sk = shape
    geom = (e, m, n, k, -(-m // bm), -(-n // bn), -(-k // sk))
    kind = bsk.route(K3, *dtypes, n, k)
    assert kind == want_route
    assert bsk.route_splits(kind, geom, bm, bn, H100_SMS) == want_splits
