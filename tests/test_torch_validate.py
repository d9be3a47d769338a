"""The invariant validators against the JAX package's.

Every validator of ``repro_torch.sparse.validate`` runs beside its JAX
counterpart on structures built from the same numpy inputs by each
package's own constructors (``sparsify``/``relu``/``plan_weight``,
``front_pack``/``stable_partition``, sparse and paged KV caches, the page
allocator, the tuner's ``record``): both pass on the valid ones, and on
each single-field mutation both raise ``ValidationError`` with the same
message.  Then the dispatch boundary's opt-in, the ``REPRO_VALIDATE``
switch, and ``Engine.validate_state`` over a smoke run with
``RunConfig(validate=True)`` (every tick validated) and on a broken
engine state.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.scheduler import PageAllocator as JAlloc
from repro.sparse import activation as jact
from repro.sparse import autotune as jatn
from repro.sparse import kvcache as jkvc
from repro.sparse import plan as jpln
from repro.sparse import validate as jval
from repro.sparse import weights as jwts
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.models import transformer as ttfm
from repro_torch.serving import engine as teng
from repro_torch.serving.scheduler import PageAllocator as TAlloc
from repro_torch.sparse import activation as tact
from repro_torch.sparse import autotune as tatn
from repro_torch.sparse import dispatch as tdsp
from repro_torch.sparse import kvcache as tkvc
from repro_torch.sparse import plan as tpln
from repro_torch.sparse import validate as tval
from repro_torch.sparse import weights as twts

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _env_driven():
    jval.reset()
    tval.reset()
    yield
    jval.reset()
    tval.reset()


def _outcome(fn):
    """None when ``fn()`` passes, else the ValidationError's message."""
    try:
        fn()
    except AssertionError as e:
        assert type(e).__name__ == "ValidationError", repr(e)
        return str(e)
    return None


def _same(jfn, tfn, raises=None):
    """Both validators agree; ``raises`` (a message fragment) says they
    must both fail, None that they must both pass."""
    jo, to = _outcome(jfn), _outcome(tfn)
    assert to == jo
    if raises is None:
        assert to is None
    else:
        assert to is not None and raises in to


# a few awkward shapes, each drawn at several densities (the JAX side
# compiles once per shape)
SHAPES = ((1, 7, 4), (3, 40, 16), (2, 70, 32))


def _draws(seed, n=9):
    g = np.random.default_rng(seed)
    for i in range(n):
        rows, k, slice_k = SHAPES[i % len(SHAPES)]
        mask = g.random((rows, k)) < g.random()
        yield k, slice_k, mask


def _both_sparsify(x, mask, slice_k):
    return (jact.sparsify(jnp.asarray(x), mask=jnp.asarray(mask),
                          slice_k=slice_k),
            tact.sparsify(torch.from_numpy(x), mask=torch.from_numpy(mask),
                          slice_k=slice_k))


# ---------------------------------------------------------------------------
# SparseActivation / PlannedWeight
# ---------------------------------------------------------------------------

def test_sparse_activation_validators_match_jax():
    for k, slice_k, mask in _draws(0):
        x = np.where(mask, 1.0, 0.0).astype(np.float32)
        ja, ta = _both_sparsify(x, mask, slice_k)
        _same(lambda: jval.check_sparse_activation(ja, strict=True),
              lambda: tval.check_sparse_activation(ta, strict=True))
        if ja.slice_act.size:
            _same(lambda: jval.check_sparse_activation(
                      dataclasses.replace(ja, slice_act=~ja.slice_act)),
                  lambda: tval.check_sparse_activation(
                      dataclasses.replace(ta, slice_act=~ta.slice_act)),
                  raises="slice_act")
    # a value outside the bitmap: fine non-strict, caught strict
    x = np.zeros((2, 40), np.float32)
    ja, ta = _both_sparsify(x, x != 0, 8)
    jl = dataclasses.replace(ja, values=ja.values.at[0, 3].set(7.0))
    tv = ta.values.clone()
    tv[0, 3] = 7.0
    tl = dataclasses.replace(ta, values=tv)
    _same(lambda: jval.check_sparse_activation(jl),
          lambda: tval.check_sparse_activation(tl))
    _same(lambda: jval.check_sparse_activation(jl, strict=True),
          lambda: tval.check_sparse_activation(tl, strict=True),
          raises="outside the bitmap")
    # metadata shapes
    ja, ta = jact.relu(jnp.ones((3, 32)), slice_k=8), \
        tact.relu(torch.ones(3, 32), slice_k=8)
    _same(lambda: jval.check_sparse_activation(dataclasses.replace(
              ja, slice_act=ja.slice_act[:, :-1])),
          lambda: tval.check_sparse_activation(dataclasses.replace(
              ta, slice_act=ta.slice_act[:, :-1])), raises="shape")
    _same(lambda: jval.check_sparse_activation(dataclasses.replace(
              ja, bitmap=ja.bitmap[:2])),
          lambda: tval.check_sparse_activation(dataclasses.replace(
              ta, bitmap=ta.bitmap[:2])), raises="bitmap shape")


@pytest.mark.parametrize("shape", [(64, 32), (3, 32, 16)])
def test_planned_weight_validators_match_jax(rng, shape):
    w = rng.normal(size=shape).astype(np.float32)
    w[rng.random(w.shape) < 0.6] = 0.0
    jw = jwts.plan_weight(jnp.asarray(w), slice_k=16, block_n=16)
    tw = twts.plan_weight(torch.from_numpy(w), slice_k=16, block_n=16)
    _same(lambda: jval.check_planned_weight(jw, values=True),
          lambda: tval.check_planned_weight(tw, values=True))
    _same(lambda: jval.check_planned_weight(dataclasses.replace(
              jw, slice_act=jnp.zeros_like(jw.slice_act)), values=True),
          lambda: tval.check_planned_weight(dataclasses.replace(
              tw, slice_act=torch.zeros_like(tw.slice_act)), values=True),
          raises="inactive")
    # the zeroed plan has the right shapes: fine without the value check
    _same(lambda: jval.check_planned_weight(dataclasses.replace(
              jw, slice_act=jnp.zeros_like(jw.slice_act))),
          lambda: tval.check_planned_weight(dataclasses.replace(
              tw, slice_act=torch.zeros_like(tw.slice_act))))
    _same(lambda: jval.check_planned_weight(dataclasses.replace(
              jw, elem_act=jnp.zeros_like(jw.elem_act)), values=True),
          lambda: tval.check_planned_weight(dataclasses.replace(
              tw, elem_act=torch.zeros_like(tw.elem_act)), values=True),
          raises="elem_act")
    _same(lambda: jval.check_planned_weight(dataclasses.replace(
              jw, elem_block_n=8)),
          lambda: tval.check_planned_weight(dataclasses.replace(
              tw, elem_block_n=8)), raises="elem_act shape")
    _same(lambda: jval.check_planned_weight(dataclasses.replace(
              jw, slice_k=8)),
          lambda: tval.check_planned_weight(dataclasses.replace(
              tw, slice_k=8)), raises="slice_act shape")


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def _acts(seed, n=16):
    g = np.random.default_rng(seed)
    for i in range(n):
        shape = ((1, 1), (4, 9), (3, 17), (5, 6))[i % 4]
        yield g.random(shape) < g.random()


def test_schedule_validators_match_jax():
    corrupted = 0
    for act in _acts(2):
        jks, jc = jpln.front_pack(jnp.asarray(act))
        tks, tc = tpln.front_pack(torch.from_numpy(act))
        _same(lambda: jval.check_schedule(jks, jc, act),
              lambda: tval.check_schedule(tks, tc, act))
        jp, jpc = jpln.stable_partition(jnp.asarray(act))
        tp, tpc = tpln.stable_partition(torch.from_numpy(act))
        _same(lambda: jval.check_schedule(jp, jpc, act, tail="partition"),
              lambda: tval.check_schedule(tp, tpc, act, tail="partition"))
        # mutations: the count, the tail, an inactive position
        _same(lambda: jval.check_schedule(jks, np.asarray(jc) + 1, act),
              lambda: tval.check_schedule(tks, tc + 1, act),
              raises="counts")
        inactive = np.flatnonzero(~act[0])
        if int(tc[0]) and inactive.size:
            jbad = np.asarray(jks).copy()
            jbad[0, 0] = inactive[0]
            tbad = tks.clone()
            tbad[0, 0] = int(inactive[0])
            _same(lambda: jval.check_schedule(jbad, jc, act),
                  lambda: tval.check_schedule(tbad, tc, act),
                  raises="schedule")
            corrupted += 1
        if act.shape[1] > 1 and int(tc[0]) < act.shape[1]:
            jbad = np.asarray(jks).copy()
            jbad[0, -1] = (jbad[0, -1] + 1) % act.shape[1]
            tbad = tks.clone()
            tbad[0, -1] = int(jbad[0, -1])
            _same(lambda: jval.check_schedule(jbad, jc, act),
                  lambda: tval.check_schedule(tbad, tc, act),
                  raises="schedule")
    assert corrupted > 3
    act = np.asarray([[True, False, True]])
    jks, jc = jpln.front_pack(jnp.asarray(act))
    tks, tc = tpln.front_pack(torch.from_numpy(act))
    _same(lambda: jval.check_schedule(np.asarray(jks) + 5, jc, act),
          lambda: tval.check_schedule(tks + 5, tc, act),
          raises="out of range")
    _same(lambda: jval.check_schedule(jks[:, :2], jc, act),
          lambda: tval.check_schedule(tks[:, :2], tc, act),
          raises="width")


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def test_sparse_kv_validator_matches_jax(rng):
    jc = jkvc.init_sparse_cache(2, 32, 2, 8, block_t=8)
    tc = tkvc.init_sparse_cache(2, 32, 2, 8, block_t=8, device="cpu")
    for t in (5, 1, 1, 9):
        k = rng.normal(size=(2, t, 2, 8)).astype(np.float32)
        jc = jkvc.update(jc, jnp.asarray(k), jnp.asarray(k))
        tc = tkvc.update(tc, torch.from_numpy(k).bfloat16(),
                         torch.from_numpy(k).bfloat16())
        _same(lambda: jval.check_kv(jc), lambda: tval.check_kv(tc))
    _same(lambda: jval.check_kv(jc._replace(blk=jc.blk.at[0].add(1))
                                if hasattr(jc, "_replace") else
                                dataclasses.replace(jc, blk=jc.blk.at[0]
                                                    .add(1))),
          lambda: tval.check_kv(dataclasses.replace(tc, blk=tc.blk + (
              torch.arange(tc.blk.numel()) == 0).int())),
          raises="popcount")


def _paged_pair(rng):
    """The same paged pool built in both packages: 3 slots of 4 blocks of
    8, slot 0 at 11 tokens, slot 1 at 3, slot 2 idle."""
    jc = jkvc.init_paged_cache(3, 8, 8, 32, 2, 4)
    tc = tkvc.init_paged_cache(3, 8, 8, 32, 2, 4, device="cpu")
    table = np.zeros((3, 4), np.int32)
    table[0, :2] = (3, 5)
    table[1, 0] = 1
    jc = jc._replace(table=jnp.asarray(table)) if hasattr(
        jc, "_replace") else dataclasses.replace(jc, table=jnp.asarray(table))
    tc = dataclasses.replace(tc, table=torch.from_numpy(table.copy()))
    for step in range(11):
        k = rng.normal(size=(3, 1, 2, 4)).astype(np.float32)
        jc = jkvc.paged_update(jc, jnp.asarray(k), jnp.asarray(k))
        tc = tkvc.paged_update(tc, torch.from_numpy(k).bfloat16(),
                               torch.from_numpy(k).bfloat16())
    return jc, tc, table


def _rep(c, **kw):
    return c._replace(**kw) if hasattr(c, "_replace") else \
        dataclasses.replace(c, **kw)


def test_paged_kv_validator_matches_jax(rng):
    jc, tc, table = _paged_pair(rng)
    _same(lambda: jval.check_paged_kv(jc, table=table),
          lambda: tval.check_paged_kv(tc, table=table))
    dup = table.copy()
    dup[1, 1] = dup[0, 0]
    _same(lambda: jval.check_paged_kv(jc, table=dup),
          lambda: tval.check_paged_kv(tc, table=dup),
          raises="more than one")
    out = table.copy()
    out[2, 3] = 99
    _same(lambda: jval.check_paged_kv(jc, table=out),
          lambda: tval.check_paged_kv(tc, table=out), raises="host table")
    _same(lambda: jval.check_paged_kv(_rep(jc, pos=jc.pos + 1)),
          lambda: tval.check_paged_kv(_rep(tc, pos=tc.pos + 1)),
          raises="min(pos, window)")
    _same(lambda: jval.check_paged_kv(_rep(jc, table=jnp.asarray(out))),
          lambda: tval.check_paged_kv(_rep(tc,
                                           table=torch.from_numpy(out))),
          raises="device table")


# ---------------------------------------------------------------------------
# allocator, tuning cache, the dispatch boundary
# ---------------------------------------------------------------------------

def test_allocator_validator_matches_jax():
    ja, ta = JAlloc(6), TAlloc(6)
    for a in (ja, ta):
        a.free(a.alloc(3)[:2])
    _same(lambda: jval.check_allocator(ja), lambda: tval.check_allocator(ta))
    for a in (ja, ta):
        a._free.append(a._free[0])
    _same(lambda: jval.check_allocator(ja), lambda: tval.check_allocator(ta),
          raises="PageAllocator")


def test_tuning_cache_validator_matches_jax():
    jatn.reset()
    tatn.reset()
    try:
        for op, m, n, k, kn, extra in (
                ("matmul", 64, 128, 256, ("xla", 8, 8, 8), ""),
                ("grouped", 16, 32, 64, ("kernel", 16, 16, 16), "e4"),
                ("attn.value", 3, 16, 64, ("kfused", 8, 16, 32), "e8")):
            jatn.record(op, m, n, k, dtype=jnp.float32, sparsity=0.5,
                        knobs=jatn.Knobs(*kn), us=1.0, extra=extra)
            tatn.record(op, m, n, k, dtype=torch.float32, sparsity=0.5,
                        knobs=tatn.Knobs(*kn), us=1.0, extra=extra,
                        platform="cpu")
        assert tval.check_tuning_cache() == jval.check_tuning_cache(
            interpret=True)
        for mod in (jatn, tatn):
            key = sorted(mod.get_cache().entries)[0]
            mod.get_cache().entries[key].update(backend="kernel", block_m=7)
        _same(lambda: jval.check_tuning_cache(interpret=True),
              lambda: tval.check_tuning_cache(), raises="knobs_valid")
        for mod in (jatn, tatn):
            key = sorted(mod.get_cache().entries)[0]
            mod.get_cache().entries[key].update(backend="pallas", block_m=8)
        _same(lambda: jval.check_tuning_cache(interpret=True),
              lambda: tval.check_tuning_cache(), raises="unknown backend")
        for mod in (jatn, tatn):
            key = sorted(mod.get_cache().entries)[0]
            mod.get_cache().entries[key].update(backend="xla")
            mod.get_cache().entries["cpu|float32|matmul"] = {}
        _same(lambda: jval.check_tuning_cache(interpret=True),
              lambda: tval.check_tuning_cache(), raises="malformed")
    finally:
        jatn.reset()
        tatn.reset()


def test_dispatch_boundary_is_opt_in(rng, monkeypatch):
    monkeypatch.delenv("REPRO_VALIDATE", raising=False)
    tval.reset()
    x = np.linspace(-1, 1, 64, dtype=np.float32).reshape(2, 32)
    ta = tact.relu(torch.from_numpy(x), slice_k=8)
    bad = dataclasses.replace(ta, slice_act=~ta.slice_act)
    w = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
    kw = dict(mode="dual", block_m=8, block_n=8, slice_k=8)
    assert not tval.enabled()
    out, _ = tdsp.matmul(bad, w, **kw)
    assert tuple(out.shape) == (2, 16)
    with tval.enabled_within(True):
        with pytest.raises(tval.ValidationError, match="slice_act"):
            tdsp.matmul(bad, w, **kw)
        with pytest.raises(tval.ValidationError, match="slice_act"):
            tdsp.grouped_matmul(dataclasses.replace(
                bad, values=bad.values[None], bitmap=bad.bitmap[None],
                slice_act=bad.slice_act[None]), w[None], **kw)
    assert not tval.enabled()
    # the switches, as the JAX package reads them; the port reads the
    # variable at import and on reset, not on every call
    was = False
    for on in ("1", "0", ""):
        monkeypatch.setenv("REPRO_VALIDATE", on)
        assert tval.enabled() == was
        tval.reset()
        assert tval.enabled() == jval.enabled() == (on == "1")
        was = on == "1"
    tval.enable(True)
    assert tval.enabled()
    tval.reset()
    assert not tval.enabled()
    tval.check_finite(torch.ones(4))
    _same(lambda: jval.check_finite(jnp.asarray([1.0, np.nan, np.inf])),
          lambda: tval.check_finite(torch.tensor([1.0, np.nan, np.inf])),
          raises="non-finite")
    assert tval.is_concrete(torch.ones(1))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_model():
    cfg = dataclasses.replace(tsmoke("nemotron-4-340b"), sparse_mode="dual",
                              sparse_use_kernel=True, sparse_kv=True,
                              sparse_block_t=8)
    return cfg, ttfm.init_model(cfg, device="cpu", dtype=torch.float32)


def test_engine_validate_state_every_tick(smoke_model, monkeypatch):
    """With ``RunConfig(validate=True)`` every tick ends in
    ``validate_state`` (counted here), the run completes clean, and a
    broken engine state raises."""
    cfg, model = smoke_model
    calls = []
    orig = teng.Engine.validate_state

    def counted(self):
        calls.append(self.ticks)
        return orig(self)
    monkeypatch.setattr(teng.Engine, "validate_state", counted)
    eng = teng.Engine(model, cfg, slots=2, capacity=32,
                      rc=TRunConfig(act_dtype="float32", validate=True),
                      device="cpu")
    for uid, p in enumerate([[5, 6, 7], [11, 3, 9, 2], [8, 1]]):
        eng.submit(teng.Request(uid=uid, prompt=p, max_new_tokens=5))
    with tval.enabled_within(True):   # the dispatch boundary checks too
        done = eng.run_to_completion()
    assert sorted(r.status for r in done) == ["done"] * 3
    assert calls == list(range(1, eng.ticks + 1))
    monkeypatch.setattr(teng.Engine, "validate_state", orig)
    eng2 = teng.Engine(model, cfg, slots=2, capacity=32,
                       rc=TRunConfig(act_dtype="float32"), device="cpu")
    eng2.submit(teng.Request(uid=0, prompt=[1, 2, 3], max_new_tokens=8))
    eng2.step()
    eng2.step()
    eng2.validate_state()
    slot = next(i for i, r in eng2.active.items() if r is not None)
    held = eng2.pages_held[slot][0]
    eng2.allocator._free.append(held)
    eng2.allocator._free_set.add(held)
    with pytest.raises(tval.ValidationError, match="free list"):
        eng2.validate_state()
    eng2.allocator._free.pop()
    eng2.allocator._free_set.discard(held)
    eng2.table_host[slot, 3] = eng2.n_pages
    with pytest.raises(tval.ValidationError, match="does not hold"):
        eng2.validate_state()
