"""Training on one device against the JAX package: the optimizer, the
schedule, the data pipeline, gradient compression and the train step.

* ``apply_updates`` for ``adamw``, ``adamw_bf16`` and ``adafactor`` on the
  whole chatglm3-6b-smoke and mamba2-370m-smoke trees, both started from
  one JAX state (``convert.opt_state_from_jax``), three steps on the same
  gradients: parameters within 1e-6 and moments within 1e-9, the stacked
  1-D leaves (norms, Mamba vectors) with JAX's decay, cast and factored
  second moment;
* ``lr_schedule`` and ``global_norm``;
* ``SyntheticTokens`` bit-equal for each seed, step and host slice, and
  ``Prefetcher``'s order;
* int8 codes bit-equal, the scales, the error-feedback state and
  ``compressed_bytes``;
* one ``make_train_step`` (2 microbatches) against JAX's on converted
  weights: in float32 compute, gradients and ``grad_norm`` within 1e-4 x
  max, and in bf16 compute (JAX's compute copies) within 2e-2 x max;
  parameters within 1e-5 except where the gradient lies under the
  gradient tolerance (Adam's first step moves those by ±lr, so they may
  differ by 2·lr);
* 1 microbatch against 2, and the loss falling over 30 steps (the JAX
  package's ``test_training.py`` cases, on the port).

The JAX side runs compiled (``jax.jit``): ``apply_updates`` once per
(tree, optimizer) and the train step once.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import RunConfig as JRunConfig
from repro.data import pipeline as jpipe
from repro.distributed import compression as jcomp
from repro.models import transformer as jtfm
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
import repro_torch.configs as tconfigs
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import compression as tcomp
from repro_torch.models import convert
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl

torch.set_num_threads(1)

OPTIMIZERS = ("adamw", "adamw_bf16", "adafactor")
TREES = ("chatglm3-6b", "mamba2-370m")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    p, _ = jtfm.init_model(jax.random.PRNGKey(0), jconfigs.smoke_config(arch))
    return _np(p)


def _leaf(tree, name, period):
    """The JAX tree's value for port parameter ``name`` (a layer's slice
    of its stacked leaf); a stacked 1-D leaf's factored ``col`` is
    shared by its layers."""
    key, j = topt.stacked_leaf(name, period)
    for part in key.split("."):
        tree = tree[part]
    if isinstance(tree, dict):
        return {k: (v if j is None or (k == "col" and v.ndim == 1)
                    else v[j]) for k, v in tree.items()}
    return tree if j is None else tree[j]


def _close(got, want, atol, what):
    got = got.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TREES)
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_apply_updates_matches_jax(arch, name):
    cfg = tconfigs.smoke_config(arch)
    # the global norm sums the leaves in another order (a stacked leaf is
    # P tensors here), an ulp apart at times: the float32 optimizer clips
    # (grad_clip 0.5 binds), the bf16-moment ones do not, since an ulp of
    # the clip factor can move a bf16 moment by one bf16 rounding
    kw = dict(optimizer=name, learning_rate=1e-3, warmup_steps=2,
              grad_clip=0.5 if name == "adamw" else 1e3)
    jrc, trc = JRunConfig(**kw), TRunConfig(**kw)
    p = _jax_params(arch)
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.01).astype(np.float32), p)
    ostate = jopt.init_opt_state(p, jrc)
    model = convert.from_jax_params(p, cfg, device="cpu")
    params = dict(model.named_parameters())
    tstate = convert.opt_state_from_jax(_np(ostate), model, cfg,
                                        device="cpu")
    tgrads = dict(convert.from_jax_params(grads, cfg, device="cpu")
                  .named_parameters())
    step = jax.jit(functools.partial(jopt.apply_updates, rc=jrc))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    for _ in range(3):
        jp, ostate, jm = step(jp, grads, ostate)
        _, tstate, tm = topt.apply_updates(params, tgrads, tstate, trc,
                                           period=cfg.period)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert tm["lr"].item() == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(tstate.step) == int(ostate.step) == 3
    jp, ostate = _np(jp), _np(ostate)
    n_stacked_1d = 0
    for n, t in params.items():
        _close(t, _leaf(jp, n, cfg.period), 1e-6, n)
        want_m = _leaf(ostate.m, n, cfg.period)
        assert tstate.m[n].dtype == (torch.float32 if name == "adamw"
                                     else torch.bfloat16), n
        _close(tstate.m[n], want_m, 1e-9, f"m {n}")
        want_v = _leaf(ostate.v, n, cfg.period)
        if isinstance(want_v, dict):
            assert set(tstate.v[n]) == {"row", "col"}, n
            for k in ("row", "col"):
                assert tuple(tstate.v[n][k].shape) == want_v[k].shape, (n, k)
                _close(tstate.v[n][k], want_v[k], 1e-9, f"v {n} {k}")
        else:
            assert tuple(tstate.v[n].shape) == want_v.shape, n
            _close(tstate.v[n], want_v, 1e-9, f"v {n}")
        n_stacked_1d += topt.jax_ndim(n, t) == 2 and t.ndim == 1
    assert n_stacked_1d >= 4
    if name == "adafactor":
        # the factored second moment is a small fraction of the params
        v_size = sum(x.numel() for v in tstate.v.values()
                     for x in (v.values() if isinstance(v, dict) else [v]))
        assert v_size < 0.25 * sum(t.numel() for t in params.values())


def test_stacked_rank_rules():
    """The rules that read a leaf's rank read JAX's: every layer's norm
    decays and gets a bf16 compute copy, ``final_norm`` does neither."""
    assert topt.stacked_leaf("layers.5.attn.wq", 2) == (
        "layers.pos1.attn.wq", 2)
    assert topt.stacked_leaf("enc_layers.3.norm1.scale", 4) == (
        "enc_layers.pos0.norm1.scale", 3)
    assert topt.stacked_leaf("final_norm.scale", 2) == ("final_norm.scale",
                                                        None)
    scale = torch.ones(4)
    assert topt.jax_ndim("layers.0.norm1.scale", scale) == 2
    assert topt.jax_ndim("final_norm.scale", scale) == 1
    assert topt.jax_ndim("layers.0.gate_attn", torch.zeros(())) == 1
    cast = ttl.cast_compute({"layers.0.norm1.scale": scale,
                             "final_norm.scale": scale,
                             "layers.0.mamba.A_log": scale,
                             "layers.0.gate_attn": torch.zeros(())},
                            TRunConfig())
    assert cast["layers.0.norm1.scale"].dtype == torch.bfloat16
    assert cast["layers.0.mamba.A_log"].dtype == torch.bfloat16
    assert cast["final_norm.scale"].dtype == torch.float32
    assert cast["layers.0.gate_attn"].dtype == torch.float32
    assert ttl.cast_compute({"x": scale}, TRunConfig(act_dtype="float32")
                            )["x"] is scale


def test_lr_schedule_and_global_norm_match_jax(rng):
    for kw in (dict(learning_rate=1e-3, warmup_steps=10),
               dict(learning_rate=3e-4, warmup_steps=0)):
        jrc, trc = JRunConfig(**kw), TRunConfig(**kw)
        steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]
        got = [topt.lr_schedule(s, trc, total_steps=100).item()
               for s in steps]
        want = [float(jopt.lr_schedule(jnp.asarray(s), jrc, total_steps=100))
                for s in steps]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
        assert got[0] <= got[2] and got[-1] < max(got)
    tree = {"a": rng.normal(size=(8, 16)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    got = topt.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    assert got.item() == pytest.approx(float(jopt.global_norm(tree)),
                                       rel=1e-6)


# ---------------------------------------------------------------------------
# data and compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 7])
def test_synthetic_tokens_bit_equal(seed):
    for hosts in ((0, 1), (0, 2), (1, 2)):
        j = jpipe.SyntheticTokens(97, 4, 12, seed=seed, host_index=hosts[0],
                                  host_count=hosts[1])
        t = tpipe.SyntheticTokens(97, 4, 12, seed=seed, host_index=hosts[0],
                                  host_count=hosts[1])
        for step in (0, 5, 17):
            a, b = j.batch_at(step), t.batch_at(step)
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_order():
    data = tpipe.SyntheticTokens(64, 2, 8, seed=1)
    pre = tpipe.Prefetcher(data, start_step=5)
    try:
        for want in (5, 6, 7):
            step, batch = pre.next()
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          data.batch_at(want)["tokens"])
    finally:
        pre.close()


@pytest.mark.parametrize("shape", [(32, 64), (7,), (3, 5, 6)])
def test_compression_matches_jax(rng, shape):
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    x.reshape(-1)[:2] = [1.5, -2.5]          # ties of the rounding
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcomp.dequantize_int8(tq, ts, shape).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, shape)))
    g = {"w": x, "b": x.reshape(-1)[:5].copy()}
    jef = jcomp.init_error_feedback(g)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    tef = tcomp.init_error_feedback(tg)
    for _ in range(4):
        jout, jef = jcomp.ef_compress(g, jef)
        tout, tef = tcomp.ef_compress(tg, tef)
        for k in g:
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(tef[k].numpy(), np.asarray(jef[k]),
                                       rtol=0, atol=1e-6)
    assert tcomp.compressed_bytes(tg) == jcomp.compressed_bytes(g)


def test_error_feedback_tracks_the_sum(rng):
    """The JAX package's ``test_compression_roundtrip_and_error_feedback``
    on the port."""
    g = {"w": torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32))}
    ef = tcomp.init_error_feedback(g)
    total = torch.zeros_like(g["w"])
    applied = torch.zeros_like(g["w"])
    for _ in range(50):
        out, ef = tcomp.ef_compress(g, ef)
        total += g["w"]
        applied += out["w"]
    assert (torch.linalg.norm(applied - total)
            / torch.linalg.norm(total)).item() < 0.01
    assert tcomp.compressed_bytes(g) < 0.3 * 4 * g["w"].numel()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _cast_compute(p):
    """The JAX train step's bf16 compute copies: float32 leaves of rank
    >= 2 (the stacked rank) in bf16."""
    return jax.tree_util.tree_map(
        lambda w: w.astype(jnp.bfloat16)
        if w.dtype == jnp.float32 and w.ndim >= 2 else w, p)


def _train_step_matches_jax(act, grad_rtol, monkeypatch):
    """One ``make_train_step`` (2 microbatches) against JAX's on
    converted weights in compute dtype ``act``: the dtype of every
    parameter the forward runs on (JAX's traced through its own train
    step), the gradients (JAX's through its compute copies) and
    ``grad_norm`` within ``grad_rtol`` x max, the parameters within 1e-5 except where the gradient lies under
    that tolerance (Adam's first step moves those by ±lr, so they may
    differ by 2·lr)."""
    arch = "chatglm3-6b"
    jcfg, cfg = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    kw = dict(microbatches=2, learning_rate=1e-3, warmup_steps=2,
              act_dtype=act)
    jrc, trc = JRunConfig(**kw), TRunConfig(**kw)
    cast = _cast_compute if act == "bfloat16" else (lambda p: p)
    p = _jax_params(arch)
    ostate = jopt.init_opt_state(p, jrc)
    batch = jpipe.SyntheticTokens(jcfg.vocab_size, 4, 16, seed=0).batch_at(0)
    seen = {}

    def jax_spy(params, *args, **kw):
        seen["jax"] = jax.tree_util.tree_map(lambda w: w.dtype, params)
        return loss_of(params, *args, **kw)
    loss_of = jtfm.lm_loss
    with monkeypatch.context() as m:
        m.setattr(jtfm, "lm_loss", jax_spy)
        jax.eval_shape(jtl.make_train_step(jcfg, jrc), p, ostate, None,
                       batch)

    def both(p, o, b):
        micro = jtl._split_micro(b, 2)
        g = None
        for i in range(2):
            mb = jax.tree_util.tree_map(lambda x: x[i], micro)
            gi = jax.grad(lambda p: jtfm.lm_loss(cast(p), mb, jcfg,
                                                 rc=jrc)[0])(p)
            g = gi if g is None else jax.tree_util.tree_map(jnp.add, g, gi)
        g = jax.tree_util.tree_map(lambda x: x / 2, g)
        return g, jtl.make_train_step(jcfg, jrc)(p, o, None, b)
    jg, (jp, _, _, jm) = jax.jit(both)(p, ostate, batch)
    jg, jp = _np(jg), _np(jp)

    model = convert.from_jax_params(p, cfg, device="cpu")
    tstate = convert.opt_state_from_jax(_np(ostate), model, cfg,
                                        device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.requires_grad_(True)
    call = ttl.functional_call

    def port_spy(module, params, *args, **kw):
        seen["port"] = {n: w.dtype for n, w in params.items()}
        return call(module, params, *args, **kw)
    monkeypatch.setattr(ttl, "functional_call", port_spy)
    grads, loss = ttl.make_grad_fn(cfg, trc)(model, tb)
    assert set(seen["port"]) == set(grads)
    for n, dt in seen["port"].items():
        want = seen["jax"]
        for part in topt.stacked_leaf(n, cfg.period)[0].split("."):
            want = want[part]
        assert str(dt).removeprefix("torch.") == str(want), n
    gmax = max(np.abs(_leaf(jg, n, cfg.period)).max() for n in grads)
    tol = grad_rtol * gmax
    for n, g in grads.items():
        assert g.dtype == torch.float32, n
        _close(g, _leaf(jg, n, cfg.period), tol, f"grad {n}")
    model, tstate, _, tm = ttl.make_train_step(cfg, trc)(model, tstate,
                                                         None, tb)
    assert tm["loss"].item() == pytest.approx(float(jm["loss"]),
                                              rel=grad_rtol / 100)
    assert loss.item() == pytest.approx(float(jm["loss"]),
                                        rel=grad_rtol / 100)
    assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= tol
    assert tm["lr"].item() == pytest.approx(float(jm["lr"]), rel=1e-6)
    lr = tm["lr"].item()
    for n, t in model.named_parameters():
        assert t.dtype == torch.float32, n
        want = _leaf(jp, n, cfg.period)
        diff = np.abs(t.detach().numpy() - want)
        small = np.abs(_leaf(jg, n, cfg.period)) <= tol
        assert diff[~small].max(initial=0) <= 1e-5, n
        assert diff[small].max(initial=0) <= 2 * lr, n


def test_train_step_matches_jax(monkeypatch):
    _train_step_matches_jax("float32", 1e-4, monkeypatch)


def test_train_step_matches_jax_bf16(monkeypatch):
    """The path the full-width run takes: bf16 compute copies of the
    float32 masters (by JAX's stacked rank) through ``functional_call``,
    the gradients back on the masters."""
    _train_step_matches_jax("bfloat16", 2e-2, monkeypatch)


def test_grad_accum_equals_single_batch():
    """The JAX package's case on the port: 1 microbatch against 2 (bf16
    compute), within its tolerances."""
    cfg = tconfigs.smoke_config("chatglm3-6b")
    model = convert.from_jax_params(_jax_params("chatglm3-6b"), cfg,
                                    device="cpu")
    model.requires_grad_(True)
    data = tpipe.SyntheticTokens(cfg.vocab_size, 8, 16, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    g1, _ = ttl.make_grad_fn(cfg, TRunConfig(microbatches=1))(model, batch)
    g2, _ = ttl.make_grad_fn(cfg, TRunConfig(microbatches=2))(model, batch)
    for n in g1:
        np.testing.assert_allclose(g1[n].numpy(), g2[n].numpy(), rtol=2e-2,
                                   atol=2e-3, err_msg=n)


def test_loss_decreases():
    """The JAX package's ``test_loss_decreases`` on the port (its own
    initial weights): qwen1.5-110b-smoke, 30 steps."""
    cfg = tconfigs.smoke_config("qwen1.5-110b")
    rc = TRunConfig(microbatches=2, learning_rate=3e-3, warmup_steps=5)
    model = convert.from_jax_params(_jax_params("qwen1.5-110b"), cfg,
                                    device="cpu")
    ostate = topt.init_opt_state(dict(model.named_parameters()), rc)
    step = ttl.make_train_step(cfg, rc)
    data = tpipe.SyntheticTokens(cfg.vocab_size, 16, 32, seed=0)
    losses, ef = [], None
    for i in range(30):
        b = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        model, ostate, ef, m = step(model, ostate, ef, b)
        losses.append(m["loss"].item())
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.8, losses


def test_train_step_compress_matches_jax():
    """Two ``compress_grads`` steps of chatglm3-6b-smoke (2 stacked layers,
    float32 compute) against JAX's: a layer's int8 scale covers its whole
    tensor, the JAX leaf's row, so the error-feedback state, the
    parameters and ``compressed_bytes`` (summed over a stack) are JAX's.
    An element whose gradient lies an ulp from a rounding boundary of its
    code may round the other way: at most 1 in 1000 of the model's
    elements may differ by more than 1e-4 x the gradient's absmax in the
    error feedback or 1e-5 in the parameters, none by more than 2 x the
    lrs' sum."""
    arch = "chatglm3-6b"
    jcfg, cfg = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    kw = dict(microbatches=2, learning_rate=1e-3, warmup_steps=2,
              act_dtype="float32")
    jrc, trc = JRunConfig(**kw), TRunConfig(**kw)
    p = _jax_params(arch)
    data = jpipe.SyntheticTokens(jcfg.vocab_size, 4, 16, seed=0)
    step = jax.jit(jtl.make_train_step(jcfg, jrc, compress_grads=True))
    jp, jo = jax.tree_util.tree_map(jnp.asarray, p), jopt.init_opt_state(p,
                                                                         jrc)
    jef = jcomp.init_error_feedback(jp)
    model = convert.from_jax_params(p, cfg, device="cpu")
    to = topt.init_opt_state(dict(model.named_parameters()), trc)
    tef = tcomp.init_error_feedback(dict(model.named_parameters()))
    tstep = ttl.make_train_step(cfg, trc, compress_grads=True)
    for i in range(2):
        b = data.batch_at(i)
        jp, jo, jef, jm = step(jp, jo, jef, b)
        model, to, tef, tm = tstep(model, to, tef, {
            k: torch.from_numpy(v) for k, v in b.items()})
        assert tm["loss"].item() == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
    assert tcomp.compressed_bytes(tef) == jcomp.compressed_bytes(_np(jef))
    jef, jp = _np(jef), _np(jp)
    lrs = 2 * sum(float(jopt.lr_schedule(s, jrc)) for s in (1, 2))
    bad_e = bad_p = total = 0
    for n, t in model.named_parameters():
        e_ref = _leaf(jef, n, cfg.period)
        # a residual is at most half a code's step, the gradient's absmax
        # / 127, so 254 x the largest one stands for the absmax: the
        # gradients agree within 1e-4 of it
        gmax = 254 * np.abs(e_ref).max()
        diff = np.abs(t.detach().numpy() - _leaf(jp, n, cfg.period))
        bad_e += (np.abs(tef[n].numpy() - e_ref) > 1e-4 * gmax).sum()
        bad_p += (diff > 1e-5).sum()
        total += diff.size
        assert diff.max() <= lrs, n
    assert bad_e <= 1e-3 * total and bad_p <= 1e-3 * total, (bad_e, bad_p)
