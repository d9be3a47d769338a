"""Pruning and step counts: the port's ``core/pruning.py`` and
``core/stats.py`` against the JAX package's on the same numpy weights.

* Every mask function equals its JAX counterpart bit for bit, in float32
  and bf16, ties included: bf16 tile norms take few distinct values, so
  ``block_mask``'s stable rank (later tiles rank higher) decides most of
  its choices, and ``magnitude_mask`` drops every magnitude equal to its
  threshold.
* ``prune_tree`` + ``apply_masks`` on a model's named parameters equal
  JAX's on its parameter tree, the leaves matched through
  ``models/convert.py`` (one layer, so JAX's layer-stacked leaves are the
  port's tensors).
* ``mxu_steps``, ``ohmma_steps`` and ``ohmma_steps_single_side`` equal
  JAX's as integers.

Block-pruned models served on cached plans are in
``test_torch_pruned_model.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.core import pruning as jpr
from repro.core import stats as jst
from repro.models import transformer as jtfm
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.core import pruning as tpr
from repro_torch.core import stats as tst
from repro_torch.models import convert

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(w: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(w).astype(jd), torch.from_numpy(w).to(td)


def _eq(tmask: torch.Tensor, jmask) -> None:
    assert tmask.dtype == torch.bool
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def _weights(kind: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "quantized":                    # many equal magnitudes
        return rng.integers(-3, 4, shape).astype(np.float32)
    return np.full(shape, 0.5, np.float32)     # constant: all tie


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["normal", "quantized", "constant"])
@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.5, 0.9])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_magnitude_mask_matches_jax(kind, sparsity, dtype):
    jw, tw = _both(_weights(kind, (64, 48)), dtype)
    _eq(tpr.magnitude_mask(tw, sparsity), jpr.magnitude_mask(jw, sparsity))


@pytest.mark.parametrize("case", [
    ("normal", (256, 384), (32, 64), 0.5),
    ("normal", (200, 300), (64, 128), 0.5),      # ragged K and N
    ("normal", (130, 70), (16, 16), 0.3),
    ("quantized", (128, 128), (16, 16), 0.5),
    ("constant", (256, 256), (32, 32), 0.5),     # every norm ties
    ("constant", (100, 90), (32, 32), 0.7),      # ... on a ragged grid
    ("normal", (2048, 2048), (128, 128), 0.5),   # the served tile size
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_mask_matches_jax(case, dtype):
    kind, shape, block, sparsity = case
    jw, tw = _both(_weights(kind, shape, seed=shape[0]), dtype)
    got = tpr.block_mask(tw, sparsity, block=block)
    _eq(got, jpr.block_mask(jw, sparsity, block=block))
    kt, nt = -(-shape[0] // block[0]), -(-shape[1] // block[1])
    kept = int(got[::block[0], ::block[1]].sum())
    assert kept == int(round(kt * nt * (1.0 - sparsity)))


def test_block_mask_bf16_norms_tie():
    """The trap: bf16 tile norms (each square rounded to bf16, the float32
    sum rounded once) take few values, so the tie-break decides."""
    w = _weights("normal", (1024, 1024), seed=3)
    jw, tw = _both(w, "bfloat16")
    sq = torch.square(tw).reshape(32, 32, 32, 32).sum(dim=(1, 3))
    assert len(torch.unique(sq)) < 200            # of 1024 tiles
    _eq(tpr.block_mask(tw, 0.5, block=(32, 32)),
        jpr.block_mask(jw, 0.5, block=(32, 32)))


@pytest.mark.parametrize("kind", ["normal", "quantized", "constant"])
@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_structured_24_mask_matches_jax(kind, axis, dtype):
    jw, tw = _both(_weights(kind, (24, 36)), dtype)
    _eq(tpr.structured_24_mask(tw, axis), jpr.structured_24_mask(jw, axis))


def test_structured_24_mask_needs_groups_of_4():
    with pytest.raises(ValueError, match="multiple of 4"):
        tpr.structured_24_mask(torch.zeros(3, 6))


@pytest.mark.parametrize("kind", ["normal", "quantized"])
@pytest.mark.parametrize("args", [(0.75, 32, -1), (0.5, 8, 0),
                                  (0.9, 16, -1)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_vectorwise_mask_matches_jax(kind, args, dtype):
    sparsity, vec, axis = args
    jw, tw = _both(_weights(kind, (40, 70)), dtype)     # 70: a part vector
    _eq(tpr.vectorwise_mask(tw, sparsity, vec, axis),
        jpr.vectorwise_mask(jw, sparsity, vec, axis))


def test_agp_sparsity_and_bad_sparsity():
    for step in (-5, 0, 1, 250, 999, 1000, 4000):
        assert tpr.agp_sparsity(step) == jpr.agp_sparsity(step)
        assert tpr.agp_sparsity(step, s_init=0.1, s_final=0.8, t_start=10,
                                t_end=300) == jpr.agp_sparsity(
            step, s_init=0.1, s_final=0.8, t_start=10, t_end=300)
    for fn in (tpr.magnitude_mask, tpr.block_mask):
        with pytest.raises(ValueError, match="sparsity"):
            fn(torch.ones(4, 4), 1.0)


def _init(jcfg):
    """JAX ``init_model(PRNGKey(0))`` parameters, compiled once."""
    return jax.jit(lambda key: jtfm.init_model(key, jcfg)[0])(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def one_layer():
    jcfg = dataclasses.replace(jsmoke("nemotron-4-340b"), n_layers=1)
    return jcfg, _init(jcfg)


@pytest.mark.parametrize("method", ["magnitude", "2:4", "vectorwise"])
def test_prune_tree_matches_jax(one_layer, method):
    """Masks over the MLP weights of a one-layer smoke model: JAX's tree
    masked and loaded, against the port's masks applied in place."""
    jcfg, p = one_layer
    tcfg = dataclasses.replace(tsmoke("nemotron-4-340b"), n_layers=1)
    jmasks = jpr.prune_tree(p, 0.6, method=method,
                            predicate=lambda path, leaf: "mlp" in path)
    want = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jpr.apply_masks(p, jmasks)),
        tcfg, device="cpu")
    model = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, p),
                                    tcfg, device="cpu")
    masks = tpr.prune_tree(model, 0.6, method=method,
                           predicate=lambda name, t: "mlp" in name)
    assert {k for k, m in masks.items() if not m.all()} == {
        "layers.0.mlp.w_up", "layers.0.mlp.w_down"}
    assert tpr.apply_masks(model, masks) is model
    for (name, got), (_, ref) in zip(model.named_parameters(),
                                     want.named_parameters()):
        torch.testing.assert_close(got, ref, atol=0, rtol=0, msg=name)
    # a dict of tensors gets new masked tensors; the inputs stay
    d = {"a": torch.arange(1.0, 9.0).reshape(2, 4), "b": torch.ones(3)}
    dm = tpr.prune_tree(d, 0.5)
    out = tpr.apply_masks(d, dm)
    assert out["a"].tolist() == [[0, 0, 0, 0], [5, 6, 7, 8]]
    assert dm["b"].all() and d["a"].min() == 1
    with pytest.raises(ValueError, match="method"):
        tpr.prune_tree(d, 0.5, method="block")


# ---------------------------------------------------------------------------
# step counts
# ---------------------------------------------------------------------------

def _sparse_pair(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    a[rng.random(a.shape) < 0.6] = 0
    b[rng.random(b.shape) < 0.4] = 0
    a[:, : k // 3] = 0                          # dead k range on A
    b[:, : n // 4] = 0                          # dead columns of B
    a[: m // 5] = 0                             # dead rows of A
    return a, b


def _ints(sc) -> tuple:
    return tuple(int(np.asarray(x)) for x in sc)


@pytest.mark.parametrize("shape", [(64, 96, 80), (37, 200, 50),
                                   (300, 130, 257), (1, 32, 32)])
def test_step_counts_match_jax(shape):
    a, b = _sparse_pair(*shape, seed=sum(shape))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    got = tst.ohmma_steps(ta, tb)
    want = jax.jit(jst.ohmma_steps)(ja, jb)
    assert _ints(got) == _ints(want)
    np.testing.assert_allclose(float(got.speedup), float(want.speedup),
                               rtol=1e-6)
    single = jax.jit(jst.ohmma_steps_single_side, static_argnums=1)
    for m in (1, shape[0], 100):
        assert _ints(tst.ohmma_steps_single_side(tb, m)) == _ints(
            single(jb, m))
    mxu = jax.jit(jst.mxu_steps, static_argnums=(2, 3, 4, 5))
    for geom in ((256, 256, 256, 128), (32, 64, 64, 16), (16, 16, 64, 32),
                 (64, 32, 128, 256)):
        assert _ints(tst.mxu_steps(ta, tb, *geom)) == _ints(
            mxu(ja, jb, *geom))


def test_im2col_read_cost_matches_jax():
    for kind in ("dense", "csr", "bitmap"):
        for density in (0.0, 0.3, 1.0):
            assert tst.im2col_read_cost(density, kind) == \
                jst.im2col_read_cost(density, kind)
    with pytest.raises(ValueError):
        tst.im2col_read_cost(0.5, "coo")
