"""The Mamba2/SSD block against the JAX package's ``models/ssm.py``, on
the same numpy inputs made from a seed, in float32:

* ``mamba2-370m`` and ``jamba-1.5-large-398b`` (full and smoke): every
  field and the SSM and layer-pattern properties (``d_inner``,
  ``ssm_heads``, ``period``, ``n_periods``, ``layer_kind`` and
  ``layer_is_moe`` at every position); the MoE families keep period 1;
* ``_causal_conv`` with and without a tail;
* ``ssd_chunked`` at (s, chunk) in {(16, 8), (24, 8)}, with and without
  an initial state: y and the final state within 1e-5;
* ``mamba_forward`` at a length that is not a chunk multiple (the dt = 0
  padding) with ``return_state``, ``mamba_step``, and the state carried
  across two segments, each against JAX; the prefill-then-step
  continuity of the port on its own;
* ``Mamba.reset_parameters`` draws the JAX package's shapes and fixed
  values.

The JAX functions run eagerly on their XLA path (the reference has no
Pallas kernel here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import nn as jnn
from repro.models import ssm as jssm
import repro_torch.configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import ssm as tssm

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

ARCHS = ("mamba2-370m", "jamba-1.5-large-398b")
TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(**knobs):
    """(JAX, port) mamba2-370m-smoke configs with the same knobs."""
    name = "mamba2-370m-smoke"
    return (dataclasses.replace(jconfigs.get_config(name), **knobs),
            dataclasses.replace(tconfigs.get_config(name), **knobs))


def _block(seed=1, **knobs):
    """JAX ``init_mamba`` parameters of the smoke block (dt_bias and
    conv_b drawn at random: JAX starts them at zero) and the port's
    ``Mamba`` holding them."""
    jcfg, tcfg = _cfgs(**knobs)
    params, _ = jnn.unzip(jssm.init_mamba(jax.random.PRNGKey(seed), jcfg))
    params = {k: np.array(v) for k, v in params.items()}
    rng = np.random.default_rng(seed)
    for key in ("dt_bias", "conv_b"):
        params[key] = (0.3 * rng.normal(size=params[key].shape)).astype(
            np.float32)
    m = tssm.Mamba(tcfg, dtype=torch.float32)
    with torch.no_grad():
        for key in convert.MAMBA_KEYS:
            getattr(m, key).copy_(torch.from_numpy(params[key]))
    return jcfg, tcfg, {k: jnp.asarray(v) for k, v in params.items()}, m


def _x(rng, b, s, d):
    return (0.3 * rng.normal(size=(b, s, d))).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [*ARCHS, *(f"{a}-smoke" for a in ARCHS)])
def test_configs_match_jax(name):
    tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
    tnames = {f.name for f in dataclasses.fields(tcfg)}
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), \
            field.name
    for field in dataclasses.fields(jcfg):
        if field.name not in tnames:
            assert getattr(jcfg, field.name) == field.default, field.name
    for prop in ("hd", "d_inner", "ssm_heads", "period", "n_periods"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    for pos in range(2 * tcfg.period):
        assert tcfg.layer_kind(pos) == jcfg.layer_kind(pos), pos
        assert tcfg.layer_is_moe(pos) == jcfg.layer_is_moe(pos), pos
    assert tconfigs.runnable_shapes(name)[-1].name == "long_500k"
    if tcfg.family == "ssm":
        assert (tcfg.period, tcfg.tie_embeddings) == (1, True)
        assert tcfg.layer_kind(0) == "mamba" and not tcfg.layer_is_moe(0)
    else:
        assert tcfg.period == 8 and not tcfg.tie_embeddings
        assert [tcfg.layer_kind(p) for p in range(8)] == ["attn"] + \
            ["mamba"] * 7
        assert [tcfg.layer_is_moe(p) for p in range(8)] == [False, True] * 4
    assert tcfg.ssm_heads * tcfg.ssm_head_dim == tcfg.d_inner


@pytest.mark.parametrize("name", ["mixtral-8x7b", "qwen3-moe-235b-a22b",
                                  "nemotron-4-340b", "whisper-base"])
def test_other_families_keep_period_one(name):
    tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
    assert tcfg.period == jcfg.period == 1
    assert tcfg.n_periods == jcfg.n_periods == tcfg.n_layers
    assert (tcfg.moe_every, tcfg.ssm_state, tcfg.attn_every) == (1, 0, 0)
    assert tcfg.layer_is_moe(0) == bool(tcfg.n_experts)


def test_decode_32k_run_configs():
    """jamba quantizes its KV at decode_32k; mamba2 has no override."""
    rc = tconfigs.get_run_config("jamba-1.5-large-398b", "decode_32k")
    assert rc.kv_quant and rc.attn_chunk == 2048
    assert not tconfigs.get_run_config("mamba2-370m", "decode_32k").kv_quant


# ---------------------------------------------------------------------------
# the block's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_jax(rng, with_tail):
    b, s, cd, k = 2, 7, 24, 4
    xbc = rng.normal(size=(b, s, cd)).astype(np.float32)
    w = (0.3 * rng.normal(size=(k, cd))).astype(np.float32)
    bias = rng.normal(size=(cd,)).astype(np.float32)
    tail = (rng.normal(size=(b, k - 1, cd)).astype(np.float32)
            if with_tail else None)
    want = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                             jnp.asarray(bias),
                             None if tail is None else jnp.asarray(tail))
    got = tssm._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                            torch.from_numpy(bias),
                            None if tail is None else torch.from_numpy(tail))
    _close(got, want)


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("s,chunk", [(16, 8), (24, 8)])
def test_ssd_chunked_matches_jax(rng, s, chunk, with_init):
    """Two groups of two heads each (the head-major group layout)."""
    jcfg, tcfg = _cfgs(ssm_chunk=chunk)
    b, h, p, g, n = 2, 4, 8, 2, 16
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (rng.random((b, s, h)) * 0.5 + 0.1).astype(np.float32)
    a = -(rng.random(h) + 0.5).astype(np.float32)
    bmat = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cmat = rng.normal(size=(b, s, g, n)).astype(np.float32)
    init = (rng.normal(size=(b, h, p, n)).astype(np.float32)
            if with_init else None)
    jy, jst = jssm.ssd_chunked(
        *map(jnp.asarray, (x, dt, a, bmat, cmat)), jcfg,
        init_state=None if init is None else jnp.asarray(init))
    ty, tst = tssm.ssd_chunked(
        *map(torch.from_numpy, (x, dt, a, bmat, cmat)), tcfg,
        init_state=None if init is None else torch.from_numpy(init))
    assert ty.dtype == tst.dtype == torch.float32
    _close(ty, jy)
    _close(tst, jst)


def test_mamba_forward_return_state_matches_jax(rng):
    """S = 13 over chunks of 8: three padded steps with dt = 0."""
    jcfg, tcfg, params, m = _block()
    x = _x(rng, 2, 13, tcfg.d_model)
    jy, jst = jssm.mamba_forward(params, jnp.asarray(x), jcfg,
                                 return_state=True)
    ty, tst = tssm.mamba_forward(m, torch.from_numpy(x), tcfg,
                                 return_state=True)
    _close(ty, jy)
    _close(tst.state, jst.state)
    _close(tst.conv, jst.conv)
    assert tuple(tst.conv.shape) == (2, tcfg.ssm_conv - 1,
                                     tssm.conv_dim(tcfg))
    assert tssm.mamba_forward(m, torch.from_numpy(x), tcfg)[1] is None


def test_mamba_step_matches_jax(rng):
    jcfg, tcfg, params, m = _block(seed=2)
    b, cd = 2, tssm.conv_dim(tcfg)
    st = (0.5 * rng.normal(size=(b, tcfg.ssm_heads, tcfg.ssm_head_dim,
                                 tcfg.ssm_state))).astype(np.float32)
    conv = rng.normal(size=(b, tcfg.ssm_conv - 1, cd)).astype(np.float32)
    x = _x(rng, b, 1, tcfg.d_model)
    jy, jst = jssm.mamba_step(params, jnp.asarray(x), jcfg,
                              jssm.SSMState(jnp.asarray(st),
                                            jnp.asarray(conv)))
    ty, tst = tssm.mamba_step(m, torch.from_numpy(x), tcfg,
                              tssm.SSMState(torch.from_numpy(st),
                                            torch.from_numpy(conv)))
    _close(ty, jy)
    _close(tst.state, jst.state)
    _close(tst.conv, jst.conv)


def test_state_passing_across_segments_matches_jax(rng):
    """forward(x) == forward(x1); forward(x2 | state), on both sides."""
    jcfg, tcfg, params, m = _block(seed=3)
    x = _x(rng, 2, 16, tcfg.d_model)
    y1, st = tssm.mamba_forward(m, torch.from_numpy(x[:, :9]), tcfg,
                                return_state=True)
    y2, _ = tssm.mamba_forward(m, torch.from_numpy(x[:, 9:]), tcfg,
                               state=st)
    full, _ = tssm.mamba_forward(m, torch.from_numpy(x), tcfg)
    _close(torch.cat([y1, y2], 1), full.numpy(), dict(atol=2e-5, rtol=2e-5))
    jy1, jst = jssm.mamba_forward(params, jnp.asarray(x[:, :9]), jcfg,
                                  return_state=True)
    jy2, _ = jssm.mamba_forward(params, jnp.asarray(x[:, 9:]), jcfg,
                                state=jst)
    _close(y1, jy1)
    _close(y2, jy2)


def test_forward_then_step_continuity(rng):
    """prefill(S) and then steps give the last outputs of one forward
    over S + t tokens (the port on its own)."""
    _, tcfg, _, m = _block(seed=4)
    s, t = 11, 3
    x = torch.from_numpy(_x(rng, 1, s + t, tcfg.d_model))
    full, _ = tssm.mamba_forward(m, x, tcfg)
    _, st = tssm.mamba_forward(m, x[:, :s], tcfg, return_state=True)
    for i in range(t):
        y, st = tssm.mamba_step(m, x[:, s + i:s + i + 1], tcfg, st)
        _close(y, full[:, s + i:s + i + 1].numpy(), dict(atol=2e-5,
                                                         rtol=2e-5))


def test_reset_parameters_matches_jax_init():
    jcfg, tcfg = _cfgs()
    want, _ = jnn.unzip(jssm.init_mamba(jax.random.PRNGKey(0), jcfg))
    m = tssm.Mamba(tcfg, dtype=torch.float32)
    m.reset_parameters(torch.Generator().manual_seed(0))
    for key in convert.MAMBA_KEYS:
        assert tuple(getattr(m, key).shape) == want[key].shape, key
    for key in ("conv_b", "dt_bias", "A_log", "D", "norm"):
        _close(getattr(m, key), want[key], dict(atol=1e-6, rtol=1e-6))
    for key, std in (("in_proj", tcfg.d_model ** -0.5), ("conv_w", 0.1),
                     ("out_proj", tcfg.d_inner ** -0.5)):
        assert abs(getattr(m, key).std().item() / std - 1) < 0.1, key
