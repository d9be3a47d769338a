"""``repro_torch.sparse.conv`` against the JAX package's
``repro.sparse.conv`` on the same numpy inputs, in float32 with the JAX
package's jnp arm (``use_kernel=False``; its Pallas conv kernels cannot
run here): ``conv2d`` in dense, weight, dual and dual+kcondense, outputs
within 1e-4 (the same float32 products summed in another order) and the
StepCounts tape equal bit for bit; ``lowered_to_activation``'s bitmap and
slice activity and ``plan_conv``'s plans equal exactly.  The port runs
its kernel chain (K5 → K6/K7 → K1/K2), which on CPU tensors is the plain
versions, and also its reference chain."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import im2col as ji2c
from repro.sparse import conv as jconv
from repro.sparse import tape as jtape
from repro_torch.core import im2col as ti2c
from repro_torch.sparse import conv as tconv
from repro_torch.sparse import tape as ttape

torch.set_num_threads(1)

# (N, H, W, C, KH, KW, F, stride)
SHAPES = [
    (2, 1, 40, 16, 1, 3, 24, 1),     # whisper's stem1 at smoke width
    (2, 1, 42, 24, 1, 3, 24, 2),     # stem2
    (1, 9, 9, 8, 3, 3, 16, 1),
    (1, 10, 11, 8, 3, 3, 16, 2),
]
MODES = {"dense": ("dense", None), "weight": ("weight", None),
         "dual": ("dual", None), "dual+kc": ("dual", "k")}
GEOM = dict(block_m=16, block_n=8, slice_k=16)


def _operands(shape, seed=0):
    """A ReLU'd input with a silent band of channels (whole k-slices of
    zeros) and a weight with dead filters (whole block columns)."""
    n, h, w, c, kh, kw, f, _ = shape
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((n, h, w, c)), 0).astype(np.float32)
    x[..., c // 2:] = 0
    wt = rng.standard_normal((kh, kw, c, f)).astype(np.float32) * 0.3
    wt[..., :8] = 0
    return x, wt


def _steps(summary):
    return [(e["name"], e["dense_steps"], e["sparse_steps"],
             e["tiles_skipped"]) for e in summary]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", SHAPES)
def test_conv2d_matches_jax(shape, mode):
    x, w = _operands(shape)
    stride = shape[-1]
    m, cond = MODES[mode]
    with jtape.collect() as je:
        jy, _ = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), stride, mode=m,
                             condense=cond, name="conv.t", **GEOM)
    for use_kernel in ((False,) if m == "dense" else (True, False)):
        with ttape.collect() as te:
            ty, _ = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                 stride, mode=m, condense=cond,
                                 use_kernel=use_kernel, name="conv.t",
                                 **GEOM)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                                   rtol=1e-4)
        tsum, jsum = ttape.summarize(te), jtape.summarize(je)
        assert _steps(tsum) == _steps(jsum)
        run_kernel = use_kernel and m != "dense"
        for e in tsum:
            assert e["executed_steps"] == (e["sparse_steps"] if run_kernel
                                           else e["dense_steps"])
        if m == "dual":
            assert tsum[0]["sparse_steps"] < tsum[0]["dense_steps"]


@pytest.mark.parametrize("shape", SHAPES)
def test_lowered_activation_matches_jax(shape):
    """The lowered activation's bitmap and slice activity are JAX's, from
    the kernel chain and the reference chain alike."""
    x, _ = _operands(shape)
    n, h, w, c, kh, kw, f, s = shape
    want = jconv.im2col_sparse(jnp.asarray(x), kh, kw, s, slice_k=16)
    for use_kernel in (True, False):
        got = tconv.im2col_sparse(torch.from_numpy(x), kh, kw, s,
                                  slice_k=16, use_kernel=use_kernel)
        np.testing.assert_array_equal(got.bitmap.numpy().view(np.uint32),
                                      np.asarray(want.bitmap))
        np.testing.assert_array_equal(got.slice_act.numpy(),
                                      np.asarray(want.slice_act))
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))
        assert got.slice_k == want.slice_k
    # one image, unbatched
    lb = ti2c.im2col_bitmap(torch.from_numpy(x[0]), kh, kw, s)
    one = tconv.lowered_to_activation(lb, 16)
    ref = jconv.lowered_to_activation(
        ji2c.im2col_bitmap(jnp.asarray(x[0]), kh, kw, s), 16)
    np.testing.assert_array_equal(one.bitmap.numpy().view(np.uint32),
                                  np.asarray(ref.bitmap))
    np.testing.assert_array_equal(one.slice_act.numpy(),
                                  np.asarray(ref.slice_act))


def test_planned_conv_matches_jax_and_bare_weights():
    """``plan_conv``'s plans are JAX's; a PlannedConv computes and counts
    what the bare weight does."""
    shape = SHAPES[1]
    x, w = _operands(shape)
    jp = jconv.plan_conv(jnp.asarray(w), slice_k=16, block_n=8)
    tp = tconv.plan_conv(torch.from_numpy(w), slice_k=16, block_n=8)
    assert tp.shape == tuple(w.shape)
    np.testing.assert_array_equal(tp.weight.slice_act.numpy(),
                                  np.asarray(jp.weight.slice_act))
    np.testing.assert_array_equal(tp.weight.elem_act.numpy(),
                                  np.asarray(jp.weight.elem_act))
    for cond in (None, "k"):
        with ttape.collect() as a:
            ya, _ = tconv.conv2d(torch.from_numpy(x), tp, 2, mode="dual",
                                 condense=cond, use_kernel=True, **GEOM)
        with ttape.collect() as b:
            yb, _ = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w), 2,
                                 mode="dual", condense=cond, use_kernel=True,
                                 **GEOM)
        assert torch.equal(ya, yb)
        assert ttape.summarize(a) == ttape.summarize(b)


def test_conv2d_checks_its_operands():
    x = torch.zeros(1, 1, 10, 4)
    with pytest.raises(ValueError, match="channel mismatch"):
        tconv.conv2d(x, torch.zeros(1, 3, 5, 2))
    with pytest.raises(ValueError, match="mode"):
        tconv.conv2d(x, torch.zeros(1, 3, 4, 2), mode="sparse")
    with pytest.warns(RuntimeWarning, match="dense mode"):
        tconv.conv2d(x, torch.zeros(1, 3, 4, 2), use_kernel=True)
