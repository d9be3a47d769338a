"""The paper's Fig. 21 / Fig. 22 step counts in the port against the JAX
package's, at the benches' smoke shapes, through ``chip_smoke.py``'s own
operand builders and loops (its phase 13 runs them at full size on the
card; the full-size integers it holds are the JAX package's).

* ``chip_smoke``'s numpy copies of ``benchmarks/bench_utils.py``'s
  ``sparse`` / ``kfiber_sparse`` draw from the generator exactly as the
  originals do;
* ``bench_spgemm.run``'s smoke grid (n = 256): ``ohmma_steps`` and
  ``mxu_steps`` equal;
* ``bench_models.run`` over ``run_conv --smoke``'s shrunk layers (and the
  GEMM layers shrunk / 4): ``ohmma_steps`` and
  ``ohmma_steps_single_side`` equal, the GEMM operands equal;
* ``bench_models.run_conv --smoke``: dense / dual / dual+kc scheduled
  steps of ``sparse.conv.conv2d`` equal (the port's sparse modes on the
  K5 → K6 → K1/K2 walks), outputs within 1e-4, executed == counted.

The JAX side is jitted where it runs eagerly in the benches: the same
computation, compiled once a shape.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as cs
from benchmarks import bench_models as jbm
from benchmarks import bench_utils as jbu
from repro.configs import paper_models as jpm
from repro.core import pruning as jpr
from repro.core import stats as jst
from repro.sparse import conv as jconv
from repro.sparse import dispatch as jdsp
from repro_torch.configs import paper_models as tpm

torch.set_num_threads(1)


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _ints(sc):
    return tuple(int(v) for v in sc)


def _smoke(layers):
    """``bench_models.run_conv --smoke``'s layers: the first two of each
    model, CONV layers' sides and channels / 4 (with its floors); GEMM
    layers, which run_conv has not, / 4 in every dimension."""
    picked = {}
    for model, layer in layers:
        picked.setdefault(model, []).append(layer)

    def shrink(layer):
        if isinstance(layer, tpm.GemmLayer):
            return layer._replace(m=layer.m // 4, k=layer.k // 4,
                                  n=layer.n // 4)
        return layer._replace(h=max(layer.h // 4, layer.k + 1),
                              w=max(layer.w // 4, layer.k + 1),
                              cin=max(layer.cin // 4, 8),
                              cout=max(layer.cout // 4, 8))
    return [(model, shrink(layer)) for model, ls in picked.items()
            for layer in ls[:2]]


def test_chip_smoke_draws_as_the_benches():
    for fn, ref in ((cs.bench_sparse, jbu.sparse),
                    (cs.bench_kfiber_sparse, jbu.kfiber_sparse)):
        r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
        for shape, s in (((5, 7), 0.3), ((2, 3, 4, 6), 0.6)):
            np.testing.assert_array_equal(fn(r1, shape, s), ref(r2, shape, s))
        assert r1.random() == r2.random()     # the same draws consumed


def test_fig21_smoke_grid_step_counts_match_jax():
    grid_a, grid_b, n = [0.0, 0.25, 0.50, 0.99, 0.999], [0.0, 0.99], 256
    got = cs.fig21_step_models(torch, "cpu", grid_a, grid_b, n)
    rng = np.random.default_rng(0)
    want = {}
    for sb in grid_b:                         # bench_spgemm.run's order
        b = jnp.asarray(jbu.sparse(rng, (n, n), sb))
        for sa in grid_a:
            a = jnp.asarray(jbu.sparse(rng, (n, n), sa))
            want[(sa, sb)] = (_ints(jst.ohmma_steps(a, b)),
                              _ints(jst.mxu_steps(a, b, 256, 256, 256, 128)))
    assert got == want
    assert len({oh for oh, _ in got.values()}) == len(got)


def _jax_layer(layer):
    return (jpm.ConvLayer if isinstance(layer, tpm.ConvLayer)
            else jpm.GemmLayer)(*layer)


_OHMMA = jax.jit(jst.ohmma_steps)
_OHMMA_SINGLE = jax.jit(jst.ohmma_steps_single_side, static_argnames="m")


def test_fig22_run_step_counts_match_jax_at_smoke_shapes(monkeypatch):
    layers = _smoke(cs.fig22_layers())
    assert len(layers) == 10 and {m for m, _ in layers} == set(tpm.MODELS)
    got, gemms = cs.fig22_step_models(torch, "cpu", layers)
    monkeypatch.setattr(jbm, "RNG", np.random.default_rng(0))
    want = {}
    for model, layer in layers:               # bench_models.run's body
        jl = _jax_layer(layer)
        conv = isinstance(jl, jpm.ConvLayer)
        a, b = jbm.conv_operands(jl) if conv else jbm.gemm_operands(jl)
        want[(model, layer.name)] = (
            _ints(_OHMMA(a, b)),
            _ints(_OHMMA_SINGLE(a.T if conv else b, m=a.shape[0])))
        if not conv:
            act, w = gemms[(model, layer.name)]
            _eq(act, a)
            _eq(w, b)
    assert got == want


def test_fig22_run_conv_schedules_match_jax_at_smoke_shapes():
    layers = _smoke(cs.fig22_layers(conv_only=True))
    blocks = (16, 16, 16)                     # run_conv --smoke's
    rng_t, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    for model, layer in layers:
        x, w = cs.conv_inputs(torch, "cpu", rng_t, layer)
        runs = cs.conv_modes(torch, x, w, layer.stride, blocks, {})
        xj = jnp.asarray(jbu.kfiber_sparse(
            rng_j, (1, layer.h, layer.w, layer.cin), layer.a_sparsity))
        wj = rng_j.normal(size=(layer.k, layer.k, layer.cin,
                                layer.cout)).astype(np.float32)
        wj = jnp.asarray(wj) * jpr.magnitude_mask(jnp.asarray(wj),
                                                  layer.w_sparsity)
        _eq(x, xj)
        _eq(w, wj)
        with jdsp.warnings_suppressed():
            for mode, (base, condense) in cs.CONV_MODES.items():
                yj, sj = jax.jit(functools.partial(
                    jconv.conv2d, stride=layer.stride, mode=base,
                    block_m=16, block_n=16, slice_k=16, condense=condense,
                    collect_stats=True))(xj, wj)
                y, st, rows, _ = runs[mode]
                assert _ints(st) == _ints(sj), (model, layer.name, mode)
                assert all(r[2] == r[3] for r in rows)
                np.testing.assert_allclose(
                    y.numpy(), np.asarray(yj), rtol=0,
                    atol=1e-4 * np.abs(np.asarray(yj)).max())
        assert int(runs["dual+kc"][1].sparse) < int(runs["dense"][1].sparse)
