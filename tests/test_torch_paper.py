"""The paper's own evaluation path in the port against the JAX package, on
the same numpy inputs (CPU; the kernels' plain walks).

* ``configs/paper_models.py`` equal to JAX's, layer for layer;
* ``core/bitmap.py``: ``encode``/``decode`` in both orders, the two-level
  round trip, ``bitmap_outer``, ``tile_activity_outer`` and ``row_nnz`` —
  packed words (the port's int32 bit patterns viewed as uint32),
  condensed values and tile bitmaps bit-equal;
* ``core/im2col.py``: ``extract_patches``, ``im2col_dense``,
  ``im2col_outer``, ``csr_encode`` and ``im2col_csr`` equal (pure copies);
* ``core/spconv.py``: ``conv2d_ref`` and ``conv2d_im2col`` within 1e-4,
  ``conv2d_dual_sparse`` (K5 → K6/K7 → K1 walks) against JAX's
  ``use_kernel=False`` arm within 1e-4, steps bit-equal;
* ``core/layers.py``: ``DualSparseLinear`` in every mode, planned or not,
  on JAX's ``init_sparse_linear`` weights carried over by
  ``models/convert.sparse_linear_from_jax``: within 1e-4, steps bit-equal;
* the entry points' device default.

The Fig. 21 / Fig. 22 step counts are in ``test_torch_paper_figs.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as jpm
from repro.core import bitmap as jbit
from repro.core import im2col as ji2c
from repro.core import layers as jly
from repro.core import pruning as jpr
from repro.core import spconv as jspc
from repro_torch.configs import paper_models as tpm
from repro_torch.core import bitmap as tbit
from repro_torch.core import im2col as ti2c
from repro_torch.core import layers as tly
from repro_torch.core import spconv as tspc
from repro_torch.models import convert

torch.set_num_threads(1)


def _sparse(rng, shape, density):
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.random(shape) >= density] = 0
    return x


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _words(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int32
    return t.numpy().view(np.uint32)


def _ints(sc):
    return tuple(int(v) for v in sc)


def test_paper_models_match_jax():
    assert list(tpm.MODELS) == list(jpm.MODELS)
    for name, layers in tpm.MODELS.items():
        jlayers = jpm.MODELS[name]
        assert [type(x).__name__ for x in layers] == \
            [type(x).__name__ for x in jlayers]
        assert [tuple(x) for x in layers] == [tuple(x) for x in jlayers]


@pytest.mark.parametrize("order", ["col", "row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_decode_match_jax(order, dtype):
    rng = np.random.default_rng(0)
    x = _sparse(rng, (64, 96), 0.3)
    x[:, 5] = 0
    x[7] = 0
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    je, te = jbit.encode(jx, order), tbit.encode(tx, order)
    np.testing.assert_array_equal(_words(te.bitmap), np.asarray(je.bitmap))
    np.testing.assert_array_equal(te.values.float().numpy(),
                                  np.asarray(je.values, np.float32))
    _eq(te.counts, je.counts)
    assert te.counts.dtype == torch.int32
    assert te.shape == je.shape and te.dtype == tx.dtype
    assert int(te.nnz) == int(je.nnz)
    td = tbit.decode(te)
    assert td.dtype == tx.dtype
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jbit.decode(je), np.float32))
    assert torch.equal(td, tx)
    with pytest.raises(ValueError):
        tbit.encode(tx, "diag")


def test_two_level_roundtrip_matches_jax():
    rng = np.random.default_rng(1)
    x = _sparse(rng, (64, 256), 0.2)
    x[:32, :128] = 0                          # an empty tile
    x[32:, 200:] = 0
    je = jbit.encode_two_level(jnp.asarray(x), 32, 128, 64)
    te = tbit.encode_two_level(torch.from_numpy(x), 32, 128, 64)
    _eq(te.values, je.values)
    np.testing.assert_array_equal(_words(te.elem_bitmap),
                                  np.asarray(je.elem_bitmap))
    _eq(te.tile_bitmap, je.tile_bitmap)
    _eq(te.slice_counts, je.slice_counts)
    assert te.grid == je.grid and te.shape == je.shape
    _eq(tbit.decode_two_level(te), jbit.decode_two_level(je))
    np.testing.assert_array_equal(tbit.decode_two_level(te).numpy(), x)
    with pytest.raises(ValueError):
        tbit.encode_two_level(torch.from_numpy(x), 32, 96, 64)


def test_bitmap_outer_tile_activity_and_row_nnz_match_jax():
    rng = np.random.default_rng(2)
    col, row = rng.random(64) < 0.4, rng.random(96) < 0.6
    jc, jr = jbit.pack_bits(jnp.asarray(col)), jbit.pack_bits(jnp.asarray(row))
    tc, tr = tbit.pack_bits(torch.from_numpy(col)), tbit.pack_bits(
        torch.from_numpy(row))
    out = tbit.bitmap_outer(tc, tr)
    np.testing.assert_array_equal(_words(out),
                                  np.asarray(jbit.bitmap_outer(jc, jr)))
    np.testing.assert_array_equal(
        tbit.unpack_bits(out, axis=1).numpy(), col[:, None] & row[None, :])
    at, bt = rng.random((3, 5)) < 0.5, rng.random((5, 4)) < 0.5
    _eq(tbit.tile_activity_outer(torch.from_numpy(at), torch.from_numpy(bt)),
        jbit.tile_activity_outer(jnp.asarray(at), jnp.asarray(bt)))
    words = jbit.pack_bits(jnp.asarray(rng.random((6, 128)) < 0.3))
    tw = torch.from_numpy(np.asarray(words).view(np.int32).copy())
    for axis in (0, -1):
        _eq(tbit.row_nnz(tw, axis=axis), jbit.row_nnz(words, axis=axis))


@pytest.mark.parametrize("kh,kw,stride", [(3, 3, 1), (3, 2, 2), (1, 3, 1)])
def test_im2col_variants_match_jax(kh, kw, stride):
    rng = np.random.default_rng(3)
    x = _sparse(rng, (9, 11, 5), 0.4)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for name in ("extract_patches", "im2col_dense", "im2col_outer",
                 "im2col_csr"):
        _eq(getattr(ti2c, name)(tx, kh, kw, stride),
            getattr(ji2c, name)(jx, kh, kw, stride))
    flat = x.reshape(9, 55)
    jcsr = ji2c.csr_encode(jnp.asarray(flat))
    tcsr = ti2c.csr_encode(torch.from_numpy(flat))
    for field in ("data", "indices", "indptr"):
        _eq(getattr(tcsr, field), getattr(jcsr, field))
    assert tcsr.shape == jcsr.shape
    assert tcsr.indices.dtype == tcsr.indptr.dtype == torch.int32


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_ref_and_im2col_match_jax(stride):
    rng = np.random.default_rng(4)
    x = _sparse(rng, (2, 9, 10, 4), 0.5)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    ref = np.asarray(jspc.conv2d_ref(jnp.asarray(x), jnp.asarray(w), stride))
    tol = 1e-4 * np.abs(ref).max()
    for fn in (tspc.conv2d_ref, tspc.conv2d_im2col):
        out = fn(torch.from_numpy(x), torch.from_numpy(w), stride)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)
    np.testing.assert_allclose(
        tspc.conv2d_im2col(torch.from_numpy(x), torch.from_numpy(w),
                           stride).numpy(),
        np.asarray(jspc.conv2d_im2col(jnp.asarray(x), jnp.asarray(w),
                                      stride)), rtol=0, atol=tol)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_dual_sparse_matches_jax(stride):
    rng = np.random.default_rng(5)
    x = _sparse(rng, (2, 10, 12, 8), 0.4)
    x[0] = 0                                  # whole empty row blocks
    w = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    w *= np.asarray(jpr.magnitude_mask(jnp.asarray(w), 0.6))
    j = jspc.conv2d_dual_sparse(jnp.asarray(x), jnp.asarray(w), stride,
                                block_m=16, block_n=16, block_k=16,
                                use_kernel=False)
    for use_kernel in (True, False):
        t = tspc.conv2d_dual_sparse(torch.from_numpy(x), torch.from_numpy(w),
                                    stride, block_m=16, block_n=16,
                                    block_k=16, use_kernel=use_kernel,
                                    device="cpu")
        assert _ints(t.steps) == _ints(j.steps)
        assert int(t.steps.sparse) < int(t.steps.dense)
        np.testing.assert_allclose(
            t.out.numpy(), np.asarray(j.out), rtol=0,
            atol=1e-4 * np.abs(np.asarray(j.out)).max())


def _linear_params(key_seed, cfg_j, rng):
    params = jly.init_sparse_linear(jax.random.PRNGKey(key_seed), cfg_j)
    w = np.asarray(params["w"])
    params = dict(params, mask=jpr.magnitude_mask(jnp.asarray(w), 0.7))
    if cfg_j.use_bias:
        params["b"] = jnp.asarray(rng.normal(size=cfg_j.out_features)
                                  .astype(np.float32))
    return params


@pytest.mark.parametrize("mode", ["dense", "weight", "dual"])
@pytest.mark.parametrize("planned", [True, False])
@pytest.mark.parametrize("use_bias", [True, False])
def test_dual_sparse_linear_matches_jax(mode, planned, use_bias):
    rng = np.random.default_rng(6)
    knobs = dict(in_features=96, out_features=40, mode=mode,
                 use_bias=use_bias, block_m=16, block_n=16, block_k=32,
                 collect_stats=True)
    cfg_j = jly.SparseLinearConfig(**knobs)
    cfg_t = tly.SparseLinearConfig(**knobs, use_kernel=True)
    pj = _linear_params(0, cfg_j, rng)
    pt = convert.sparse_linear_from_jax(
        {k: np.asarray(v) for k, v in pj.items()}, device="cpu")
    assert pt["mask"].dtype == torch.bool and pt["w"].dtype == torch.float32
    if planned:
        pj, pt = jly.plan_sparse_linear(pj, cfg_j), tly.plan_sparse_linear(
            pt, cfg_t)
        _eq(pt["plan"].slice_act, pj["plan"].slice_act)
    x = np.maximum(rng.normal(size=(2, 24, 96)).astype(np.float32), 0)
    x[:, :16, :32] = 0                        # a whole empty block
    yj, sj = jly.apply_sparse_linear(pj, jnp.asarray(x), cfg_j)
    yt, st = tly.apply_sparse_linear(pt, torch.from_numpy(x), cfg_t,
                                     device="cpu")
    assert yt.shape == (2, 24, 40)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(yj)).max())
    assert _ints(st) == _ints(sj)
    if mode == "dual":
        assert int(st.sparse) < int(st.dense)


def test_init_sparse_linear_and_entry_points():
    cfg = tly.SparseLinearConfig(in_features=64, out_features=8,
                                 use_bias=True)
    gen = torch.Generator().manual_seed(0)
    p = tly.init_sparse_linear(gen, cfg, device="cpu")
    assert p["w"].shape == (64, 8) and p["mask"].all() and not p["b"].any()
    assert p["w"].abs().max() <= 1 / 8
    p2 = tly.init_sparse_linear(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    assert torch.equal(p["w"], p2["w"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None rightly runs on it")
    x, w = torch.zeros(1, 5, 5, 2), torch.zeros(3, 3, 2, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tspc.conv2d_dual_sparse(x, w)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tly.apply_sparse_linear(p, torch.zeros(2, 64), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tly.init_sparse_linear(gen, cfg)
