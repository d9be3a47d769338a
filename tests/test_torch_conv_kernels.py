"""The conv kernels' plain versions against the JAX package: K5
(``bitmap_encode``) against ``kernels/ref.py::encode_ref``, K6/K7
(``sparse_im2col`` / ``sparse_im2col_strided``) against
``core/im2col.py::im2col_bitmap`` through the JAX package's own
``rowpacked_to_flat``, and the port's conversion and whole chain against
JAX's.  Everything is exact: the kernels only move data, so bitmaps equal
as uint32 patterns and values bit for bit.  (The JAX package's Pallas
conv kernels cannot run here; their references can.)

Shapes cover whisper's stem (H=1, 1x3, stride 1 and 2), 3x3 at strides 1
and 2, a patch conv (k = s = 4), W and OW off multiples of 32, windows
that cross or end on a word boundary, all-zero and all-non-zero rows, and
words with bit 31 set."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as jbm
from repro.core import im2col as ji2c
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import bitmap as tbm
from repro_torch.core import im2col as ti2c
from repro_torch.kernels import bitmap_encode as k5
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sparse_im2col as k67

torch.set_num_threads(1)

# the references, compiled once per shape (eager JAX is slower here)
j_im2col = jax.jit(ji2c.im2col_bitmap, static_argnums=(1, 2, 3))
j_to_flat = jax.jit(jops.rowpacked_to_flat, static_argnums=(2, 3))
j_encode = jax.jit(jref.encode_ref)

# (N, H, W, C, kh, kw, stride)
SHAPES = [
    (2, 1, 50, 8, 1, 3, 1),     # whisper conv1-like
    (2, 1, 52, 8, 1, 3, 2),     # whisper conv2-like
    (1, 7, 9, 3, 3, 3, 1),
    (2, 9, 10, 2, 3, 3, 2),
    (1, 8, 8, 3, 4, 4, 4),      # patch conv, k = s
    (1, 1, 66, 2, 1, 34, 1),    # window starts at dx >= 32, crosses words
    (1, 1, 65, 2, 1, 2, 1),     # OW = 64: the window ends on a boundary
    (1, 1, 100, 2, 1, 33, 2),   # strided, dx >= 32
    (1, 2, 96, 3, 2, 1, 1),     # W and OW multiples of 32
]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _feature_map(shape, seed):
    """NHWC, about half zeros, with an all-zero and an all-non-zero row
    and bit 31 of the first word set in every other row."""
    n, h, w, c = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    x[rng.random(x.shape) < 0.5] = 0
    x[0, 0, :, 0] = 0                                    # all-zero row
    x[-1, -1, :, -1] = rng.uniform(0.5, 2.0, w)          # all-non-zero row
    if w >= 32:
        x[:, :, 31, ::2] = 1.5                            # bit 31 set
    return x


def _to_jax(t: torch.Tensor):
    """An int32 bit-pattern tensor as JAX's uint32 words."""
    return jnp.asarray(t.numpy().view(np.uint32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES[:5])
def test_encode_plain_matches_encode_ref(shape, dtype):
    n, h, w, c = shape[:4]
    x = _feature_map((n, h, w, c), 1)
    jdt, tdt = DTYPES[dtype]
    xt = torch.from_numpy(x).to(tdt)
    bits, cond = k5.bitmap_encode(xt.permute(0, 3, 1, 2), device="cpu")
    assert bits.dtype == torch.int32 and cond.dtype == tdt
    assert tuple(bits.shape) == (n, c, h, -(-w // 32))
    for i in range(n):
        rows = np.moveaxis(x[i], -1, 0).reshape(c * h, w)
        pk, cd, _, _ = j_encode(jnp.asarray(rows, jdt))
        np.testing.assert_array_equal(
            bits[i].reshape(c * h, -1).numpy().view(np.uint32),
            np.asarray(pk))
        np.testing.assert_array_equal(
            cond[i].reshape(c * h, w).float().numpy(),
            np.asarray(cd.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_im2col_plain_matches_reference(shape, dtype):
    """K6 (stride 1) / K7 (stride >= 2) plain, row-packed, through JAX's
    rowpacked_to_flat == JAX's im2col_bitmap; the port's conversion ==
    JAX's; the port's chain and reference == JAX's too."""
    n, h, w, c, kh, kw, s = shape
    x = _feature_map((n, h, w, c), 2)
    jdt, tdt = DTYPES[dtype]
    xt = torch.from_numpy(x).to(tdt)
    bits, cond = k5.bitmap_encode(xt.permute(0, 3, 1, 2), device="cpu")
    if s == 1:
        low_bits, low_vals = k67.sparse_im2col(cond, bits, kh=kh, kw=kw,
                                               device="cpu")
    else:
        low_bits, low_vals = k67.sparse_im2col_strided(
            cond, bits, kh=kh, kw=kw, stride=s, device="cpu")
    oh, ow = ti2c.out_size(h, kh, s), ti2c.out_size(w, kw, s)
    p = oh * ow
    assert tuple(low_bits.shape) == (n, kh * kw * c, oh, -(-ow // 32))
    assert tuple(low_vals.shape) == (n, kh * kw * c, p)
    chain = tops.sparse_im2col(xt, kh, kw, s, device="cpu")
    ref = ti2c.im2col_bitmap(xt, kh, kw, s)
    for i in range(n):
        want = j_im2col(jnp.asarray(x[i], jdt), kh, kw, s)
        got = j_to_flat(
            _to_jax(low_bits[i]),
            jnp.asarray(low_vals[i].float().numpy(), jdt), ow, p)
        mine = tops.rowpacked_to_flat(low_bits[i], low_vals[i], ow, p)
        for field in ("bitmap", "values", "counts"):
            w_ = np.asarray(getattr(want, field))
            np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                          w_)
            for t in (mine, chain, ref):
                v = getattr(t, field)[i] if t is not mine else \
                    getattr(t, field)
                if field == "bitmap":
                    v = v.numpy().view(np.uint32)
                elif field == "values":
                    v = v.float().numpy()
                    w_ = np.asarray(want.values.astype(jnp.float32))
                else:
                    v = v.numpy()
                np.testing.assert_array_equal(v, w_)


def test_condense_and_bits_match_jax():
    """``condense`` is JAX's ``_condense``; ``pack_bits`` /
    ``unpack_bits`` over a middle axis, with bit 31 set, are JAX's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 64, 5)).astype(np.float32)
    x[rng.random(x.shape) < 0.6] = 0
    x[:, 31, :] = 1.0
    m = x != 0
    for axis in (0, 1, 2):
        np.testing.assert_array_equal(
            tbm.condense(torch.from_numpy(x), torch.from_numpy(m),
                         axis=axis).numpy(),
            np.asarray(jbm._condense(jnp.asarray(x), jnp.asarray(m),
                                     axis=axis)))
    words = tbm.pack_bits(torch.from_numpy(m), axis=1)
    np.testing.assert_array_equal(
        words.numpy().view(np.uint32),
        np.asarray(jbm.pack_bits(jnp.asarray(m), axis=1)))
    assert (words[:, 0].numpy().view(np.uint32) >= 2 ** 31).all()
    np.testing.assert_array_equal(tbm.unpack_bits(words, axis=1).numpy(), m)


def test_wrappers_use_plain_on_the_cpu_and_count_nothing():
    x = torch.from_numpy(_feature_map((1, 1, 40, 4), 4))
    before = (k5.bitmap_encode.launches, k67.sparse_im2col.launches,
              k67.sparse_im2col_strided.launches)
    bits, cond = k5.bitmap_encode(x.permute(0, 3, 1, 2), device="cpu")
    ref = k5.bitmap_encode_plain(x.permute(0, 3, 1, 2))
    assert torch.equal(bits, ref[0]) and torch.equal(cond, ref[1])
    k67.sparse_im2col(cond, bits, kh=1, kw=3, device="cpu")
    k67.sparse_im2col_strided(cond, bits, kh=1, kw=3, stride=2,
                              device="cpu")
    assert (k5.bitmap_encode.launches, k67.sparse_im2col.launches,
            k67.sparse_im2col_strided.launches) == before


def test_wrappers_default_to_the_card_and_check_shapes():
    x = torch.zeros(1, 2, 1, 40)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            k5.bitmap_encode(x)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tops.sparse_im2col(x.permute(0, 2, 3, 1), 1, 3)
    bits, cond = k5.bitmap_encode(x, device="cpu")
    with pytest.raises(ValueError, match="bits"):
        k67.sparse_im2col(cond, bits[..., :1, :1], kh=1, kw=3,
                          device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        k67.sparse_im2col_strided(cond, bits, kh=2, kw=3, stride=2,
                                  device="cpu")
