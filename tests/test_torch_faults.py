"""Fault injection and graceful degradation against the JAX package's.

Each fault kind of ``repro_torch.testing.faults`` runs on the port's
``Engine`` beside the JAX ``Engine`` under the same kind and seed, on
``nemotron-4-340b-smoke`` with the JAX weights carried across: fired
counts, statuses and errors, tokens, and ``health()``'s shared stats and
quarantines agree, and the requests a fault does not touch keep the
fault-free run's tokens.

* ``kernel_matmul`` / ``kernel_grouped`` (rate 1.0: the JAX package draws
  once per traced call, the port once per call, and at rate 1.0 both fire
  once per site, the first call, which quarantines it).  The JAX engine
  runs ``sparse_use_kernel=True`` here: the injected fault raises before
  any interpret-mode kernel runs, and the kernels it patches are all the
  run would reach.
* ``nan_logits``, ``page_alloc``, ``preemption_storm`` (host-side draws,
  any rate) and ``nan_activation`` on the JAX engine's XLA path; the
  activation fault draws per traced call there and per call here, so its
  fired counts differ by construction and only its outcome is compared,
  with the port on its plain arm as well.
* ``chaos`` — every fault at once, one poisoned uid.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.models import transformer as jtfm
from repro.serving import engine as jeng
from repro.sparse import dispatch as jdsp
from repro.sparse import site as jsite
from repro.testing import faults as jfaults
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.kernels import bitmap_spgemm as bsk
from repro_torch.models import convert
from repro_torch.serving import engine as teng
from repro_torch.sparse import activation as tact
from repro_torch.sparse import dispatch as tdsp
from repro_torch.sparse import site as tsite
from repro_torch.sparse import weights as twts
from repro_torch.testing import faults as tfaults

torch.set_num_threads(1)

ARCH = "nemotron-4-340b"
DUAL = dict(sparse_mode="dual", sparse_use_kernel=True)
DUAL_KV = dict(DUAL, sparse_kv=True, sparse_block_t=8)
PROMPTS = [[5, 6, 7], [11, 3, 9, 2], [8, 1], [2, 4, 6, 8, 10]]
SERVE = dict(slots=2, capacity=32)
SHARED_STATS = ("ticks", "evictions", "prefill_calls", "decode_calls",
                "tokens_emitted", "errored", "pages_free", "pages_total")


@pytest.fixture(autouse=True)
def _clean_slate():
    """Quarantines and warn-once state never leak across tests."""
    jsite.clear_quarantine()
    tsite.clear_quarantine()
    jw, tw = set(jdsp._WARNED), set(tdsp._WARNED)
    yield
    jsite.clear_quarantine()
    tsite.clear_quarantine()
    jdsp._WARNED.clear()
    jdsp._WARNED.update(jw)
    tdsp._WARNED.clear()
    tdsp._WARNED.update(tw)
    assert not tfaults.active() and not jfaults.active()


@pytest.fixture(scope="module")
def setup():
    p = jax.jit(lambda key: jtfm.init_model(key, jsmoke(ARCH))[0])(
        jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(lambda a: np.array(a), p)
    p["layers"]["pos0"]["mlp"]["w_up"][:, :, :128] = 0
    model = convert.from_jax_params(p, tsmoke(ARCH), device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, p), model


def _run(mod, params, knobs, jax_kernel=False, max_new=5, **serve):
    """Serve ``PROMPTS`` through one package's engine; (engine,
    {uid: request})."""
    sv = dict(SERVE, **serve)
    if mod is jeng:
        cfg = dataclasses.replace(jsmoke(ARCH), **knobs)
        if not jax_kernel:
            cfg = dataclasses.replace(cfg, sparse_use_kernel=False)
        eng = jeng.Engine(params, cfg, serve=JServeConfig(**sv),
                          rc=JRunConfig(act_dtype="float32"))
    else:
        cfg = dataclasses.replace(tsmoke(ARCH), **knobs)
        eng = teng.Engine(params, cfg, serve=TServeConfig(**sv),
                          rc=TRunConfig(act_dtype="float32"), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for uid, p in enumerate(PROMPTS):
            eng.submit(mod.Request(uid=uid, prompt=list(p),
                                   max_new_tokens=max_new))
        done = {r.uid: r for r in eng.run_to_completion()}
    assert sorted(done) == list(range(len(PROMPTS)))
    return eng, done


def _outcomes(done):
    return {u: (r.status, r.error, list(r.output)) for u, r in done.items()}


def _shared(eng):
    h = eng.health()
    return {k: h["stats"][k] for k in SHARED_STATS}, h["quarantines"]


@pytest.fixture(scope="module")
def clean(setup):
    """Fault-free runs of both packages, per config: the tokens a fault
    must leave alone."""
    jparams, model = setup
    out = {}
    for name, knobs in (("dual", DUAL), ("dual+kv", DUAL_KV)):
        _, jdone = _run(jeng, jparams, knobs)
        _, tdone = _run(teng, model, knobs)
        assert _outcomes(tdone) == _outcomes(jdone)
        out[name] = _outcomes(tdone)
    return out


def _both(setup, kind_ctx, knobs, jax_kernel=False, **serve):
    """Run both engines, each under its own package's fault context
    ``kind_ctx(faults_module)``; returns (je, jdone, jf, te, tdone, tf)."""
    jparams, model = setup
    with kind_ctx(jfaults) as jf:
        je, jdone = _run(jeng, jparams, knobs, jax_kernel=jax_kernel,
                         **serve)
    jq = jsite.quarantine_report()
    with kind_ctx(tfaults) as tf:
        te, tdone = _run(teng, model, knobs, **serve)
    assert tsite.quarantine_report() == jq
    return je, jdone, jf, te, tdone, tf


def _fired(f):
    return {k: v.fired for k, v in f.items()} if isinstance(f, dict) \
        else f.fired


# ---------------------------------------------------------------------------
# the Fault object and the patch points
# ---------------------------------------------------------------------------

def test_fault_draws_match_jax():
    for rate, seed in ((0.5, 7), (0.25, 3), (1.0, 0)):
        tf, jf = tfaults.Fault("page_alloc", rate=rate, seed=seed), \
            jfaults.Fault("page_alloc", rate=rate, seed=seed)
        assert [tf.fire() for _ in range(40)] == [jf.fire()
                                                  for _ in range(40)]
        assert tf.fired == jf.fired
        tp, jp = tfaults.Fault("nan_logits", rate=rate, seed=seed), \
            jfaults.Fault("nan_logits", rate=rate, seed=seed)
        assert [tp.poisons(u) for u in range(64)] == \
            [jp.poisons(u) for u in range(64)]
    g = tfaults.Fault("nan_logits", uids=frozenset({4, 9}))
    assert g.poisons(4) and g.poisons(9) and not g.poisons(5)
    assert tfaults.KINDS == jfaults.KINDS
    with pytest.raises(ValueError, match="unknown fault kind"):
        with tfaults.inject("cosmic_ray"):
            pass
    with tfaults.inject("page_alloc", rate=0.0):
        with pytest.raises(RuntimeError, match="already installed"):
            with tfaults.inject("page_alloc"):
                pass
    with tfaults.chaos(seed=0, poisoned_uids={3}) as inst:
        assert tfaults.active() == sorted(inst) == sorted(
            ["kernel_matmul", "kernel_grouped", "page_alloc",
             "preemption_storm", "nan_logits"])
    assert not tfaults.active()


def test_kernel_fault_patches_and_restores_the_wrappers(rng):
    """The stub replaces the wrapper where the dispatch looks it up,
    carries its launch count, and hands both back on exit; the site
    quarantines and keeps the plain arm's numbers."""
    orig = bsk.bitmap_spgemm_planned
    count = orig.launches
    cfg = dataclasses.replace(tsmoke(ARCH), **DUAL, sparse_block_m=8,
                              sparse_block_n=16, sparse_slice_k=16)
    x = tact.relu(torch.from_numpy(rng.normal(size=(8, 64)).astype(
        np.float32)), slice_k=16)
    w = twts.plan_weight(torch.from_numpy(rng.normal(size=(64, 32)).astype(
        np.float32)), slice_k=16, block_n=16)
    st = tsite.make("matmul", "faults.mm", axes=("a", "b"))
    ref, _ = tsite.matmul(x, w, st, dataclasses.replace(
        cfg, sparse_use_kernel=False))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with tfaults.inject("kernel_matmul") as f:
            assert bsk.bitmap_spgemm_planned is not orig
            assert bsk.bitmap_spgemm_planned.launches == count
            out, _ = tsite.matmul(x, w, st, cfg)
            out2, _ = tsite.matmul(x, w, st, cfg)
    assert f.fired == 1                  # quarantined after the first
    assert bsk.bitmap_spgemm_planned is orig and orig.launches == count
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(out2, ref, rtol=0, atol=0)
    assert "matmul:faults.mm" in tsite.quarantine_report()
    # an error the plain arm hits too is not the kernel's: it propagates
    bad = tact.relu(torch.ones(8, 48), slice_k=16)
    st2 = tsite.make("matmul", "faults.bad", axes=("a", "b"))
    with pytest.raises(Exception):
        tsite.matmul(bad, w, st2, cfg)
    assert "matmul:faults.bad" not in tsite.quarantine_report()
    # nan_activation poisons the sparse path's activation, then restores
    h = torch.ones(4, 32)
    with tfaults.inject("nan_activation") as fa:
        dirty = tact.activate(h, "relu", 8)
    assert fa.fired == 1 and not bool(torch.isfinite(dirty.values).all())
    assert bool(torch.isfinite(tact.activate(h, "relu", 8).values).all())


@pytest.mark.parametrize("device,error,degrades", [
    ("cpu", RuntimeError, True),
    ("cuda", tfaults.FaultInjected, True),
    ("cuda", RuntimeError, False),
])
def test_site_guard_degrades_only_cpu_or_injected_faults(device, error,
                                                         degrades):
    """The quarantine retries the plain arm for CPU operands and for an
    injected fault; on the card a kernel's own error propagates and
    quarantines nothing."""
    st = tsite.make("matmul", f"guard.{device}.{error.__name__}")
    calls = []

    def call(kw):
        calls.append(kw["use_kernel"])
        if kw["use_kernel"]:
            raise error("kernel failed")
        return "plain"
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            if degrades:
                assert tsite._guarded(st, dict(use_kernel=True), call,
                                      torch.device(device)) == "plain"
            else:
                with pytest.raises(error, match="kernel failed"):
                    tsite._guarded(st, dict(use_kernel=True), call,
                                   torch.device(device))
        assert calls == ([True, False] if degrades else [True])
        assert tsite.quarantined(st) == degrades
    finally:
        tsite.clear_quarantine()


# ---------------------------------------------------------------------------
# each kind on both engines
# ---------------------------------------------------------------------------

def test_kernel_matmul_quarantines_the_k1_sites(setup, clean):
    je, jdone, jf, te, tdone, tf = _both(
        setup, lambda fm: fm.inject("kernel_matmul"), DUAL, jax_kernel=True)
    assert tf.fired == jf.fired > 0
    assert _outcomes(tdone) == _outcomes(jdone) == clean["dual"]
    assert _shared(te) == _shared(je)
    q = _shared(te)[1]
    assert len(q) == tf.fired and all(k.startswith("matmul:") for k in q)


def test_kernel_grouped_quarantines_the_k3_sites(setup, clean):
    """K3's faults with K1's installed too, so that the JAX engine reaches
    no interpret-mode kernel."""
    def both_kernels(fm):
        return fm.chaos(seed=0, alloc_rate=0.0, storm_rate=0.0)
    je, jdone, jf, te, tdone, tf = _both(setup, both_kernels, DUAL_KV,
                                         jax_kernel=True)
    assert _fired(tf) == _fired(jf)
    assert tf["kernel_grouped"].fired == 2
    assert _outcomes(tdone) == _outcomes(jdone) == clean["dual+kv"]
    assert _shared(te) == _shared(je)
    assert {"attn.score:attn.score", "attn.value:attn.value"} <= set(
        _shared(te)[1])


def test_nan_logits_retires_the_poisoned_request(setup, clean):
    je, jdone, jf, te, tdone, tf = _both(
        setup, lambda fm: fm.inject("nan_logits", uids={1}), DUAL_KV)
    assert _outcomes(tdone) == _outcomes(jdone)
    assert tdone[1].status == "error" and tdone[1].error == \
        "nonfinite_logits"
    for uid in (0, 2, 3):
        assert _outcomes(tdone)[uid] == clean["dual+kv"][uid]
    assert _shared(te) == _shared(je) and te.errored == 1
    te.validate_state()


@pytest.mark.parametrize("kind,rate,seed", [("page_alloc", 0.5, 11),
                                            ("preemption_storm", 0.4, 5)])
def test_host_faults_keep_every_stream(setup, clean, kind, rate, seed):
    je, jdone, jf, te, tdone, tf = _both(
        setup, lambda fm: fm.inject(kind, rate=rate, seed=seed), DUAL_KV)
    assert tf.fired == jf.fired > 0
    assert _outcomes(tdone) == _outcomes(jdone) == clean["dual+kv"]
    assert _shared(te) == _shared(je)
    if kind == "preemption_storm":
        assert te.evictions >= 1
    te.validate_state()


def test_nan_activation_retires_every_request(setup):
    """Both engines on their plain arms: a NaN at an element the bitmap
    declares zero reaches a dense product, while K1's walk skips its
    inactive slice (the schedule, not the values, decides what is read)."""
    je, jdone, jf, te, tdone, tf = _both(
        setup, lambda fm: fm.inject("nan_activation"),
        dict(DUAL, sparse_use_kernel=False))
    assert tf.fired > 0 and jf.fired > 0
    assert _outcomes(tdone) == _outcomes(jdone)
    assert all(r.status == "error" and r.error == "nonfinite_logits"
               for r in tdone.values())
    assert _shared(te) == _shared(je)


def test_chaos_matches_jax(setup, clean):
    """Every fault at once: K1 and K3 quarantined, pages refused, slots
    evicted, uid 2 poisoned; the other streams keep their tokens."""
    je, jdone, jf, te, tdone, tf = _both(
        setup, lambda fm: fm.chaos(seed=3, poisoned_uids={2}), DUAL_KV,
        jax_kernel=True)
    assert _fired(tf) == _fired(jf)
    assert _outcomes(tdone) == _outcomes(jdone)
    assert tdone[2].status == "error"
    for uid in (0, 1, 3):
        assert _outcomes(tdone)[uid] == clean["dual+kv"][uid]
    assert _shared(te) == _shared(je)
    te.validate_state()
