"""Sparse-KV decode parity: the port's ``SparseKVCache``, KV planners,
decode operands, ``attend_sparse`` and ``generate`` with ``sparse_kv``
against the JAX package, on ``nemotron-4-340b-smoke`` and a
``sliding_window=8`` variant, with a capacity larger than the context and
8-slot cache blocks.

Occupancy bitmaps, schedules and StepCounts are bit-equal; f32 attention
within 1e-4; greedy tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.configs.base import RunConfig as JRunConfig
from repro.models import attention as jattn
from repro.models import cache as jkvc
from repro.models import transformer as jtfm
from repro.serving import serve_loop as jserve
from repro.sparse import kvcache as jskv
from repro.sparse import plan as jpln
from repro.sparse import tape as jtape
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.models import attention as tattn
from repro_torch.models import cache as tkvc
from repro_torch.models import convert
from repro_torch.models import transformer as ttfm
from repro_torch.serving import serve_loop as tserve
from repro_torch.sparse import kvcache as tskv
from repro_torch.sparse import plan as tpln
from repro_torch.sparse import tape as ttape

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

ARCH = "nemotron-4-340b"
KV = dict(sparse_mode="dual", sparse_kv=True, sparse_block_t=8)
CAP, BLOCK_T = 40, 8
WINDOWS = [0, 8]


def _cfgs(window=0, **kw):
    knobs = dict(KV, sliding_window=window, **kw)
    return (dataclasses.replace(jsmoke(ARCH), **knobs),
            dataclasses.replace(tsmoke(ARCH), **knobs))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _eq_words(t, j):
    np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j))


def _fill(rng, steps, window=CAP, cap=CAP, b=2, kvh=2, hd=16):
    """The same appends (a prefill, then decodes) into a JAX and a port
    sparse cache; yields both after each append."""
    jc = jskv.init_sparse_cache(b, cap, kvh, hd, window=window,
                                block_t=BLOCK_T, dtype=jnp.float32)
    tc = tskv.init_sparse_cache(b, cap, kvh, hd, window=window,
                                block_t=BLOCK_T, dtype=torch.float32,
                                device="cpu")
    for s in steps:
        k = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
        v = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
        jc = jskv.update(jc, jnp.asarray(k), jnp.asarray(v))
        tc = tskv.update(tc, torch.from_numpy(k), torch.from_numpy(v))
        yield jc, tc


# ---------------------------------------------------------------------------
# occupancy and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [CAP, 10])
def test_occupancy_bit_equal(rng, window):
    """After the prefill and after every decode append (ring wrap when
    the ring is shorter than the capacity), occ/blk/pos and the buffers
    equal JAX's."""
    for jc, tc in _fill(rng, [5, 1, 1, 1, 7, 1], window=window):
        assert tc.pos == int(jc.pos) and tc.block_t == jc.block_t
        _eq_words(tc.occ, jc.occ)
        _eq(tc.blk, jc.blk)
        _eq(tskv.occupancy_mask(tc), jskv.occupancy_mask(jc))
        _eq(tkvc.key_positions(tc), jkvc.key_positions(jc))
        _eq(tc.k, jc.k)
        _eq(tc.v, jc.v)
    jrep = jskv.occupancy_report(jc, mask_window=8)
    trep = tskv.occupancy_report(tc, mask_window=8)
    for key in ("written_frac", "evicted_frac", "live_slots"):
        assert trep[key] == jrep[key][0], key
    for key in ("capacity", "block_t", "n_blocks"):
        assert trep[key] == jrep[key], key


@pytest.mark.parametrize("pos,s,window", [(0, 5, 40), (5, 1, 40), (9, 3, 10),
                                          (3, 25, 10), (38, 4, 40)])
def test_written_slot_mask_and_key_positions(pos, s, window):
    _eq(tkvc.written_slot_mask(pos, window, CAP, s),
        jkvc.written_slot_mask(jnp.int32(pos), jnp.int32(window), CAP, s))
    _eq(tkvc.key_positions_at(pos + s, window, CAP),
        jkvc.key_positions_at(jnp.int32(pos + s), jnp.int32(window), CAP))


@pytest.mark.parametrize("window", WINDOWS)
def test_kv_decode_plan_equal(rng, window):
    """kv_decode_slots / plan_kv_decode equal JAX's after every append,
    the sliding window applied as a mask over a full-history cache."""
    w = window or None
    for jc, tc in _fill(rng, [20, 1, 1, 1]):
        qpos = tc.pos - 1
        jocc, tocc = jskv.occupancy_mask(jc), tskv.occupancy_mask(tc)
        jkpos, tkpos = jkvc.key_positions(jc), tkvc.key_positions(tc)
        _eq(tpln.kv_decode_slots(tocc, tkpos, qpos, w),
            jpln.kv_decode_slots(jocc, jkpos, jnp.int32(qpos), w))
        tp = tpln.plan_kv_decode(tocc, tkpos, qpos, w, BLOCK_T)
        jp = jpln.plan_kv_decode(jocc, jkpos, jnp.int32(qpos), w, BLOCK_T)
        for field in tp._fields:
            _eq(getattr(tp, field), getattr(jp, field))
        if window:   # the window hides block 0
            assert int(tp.count) < int(tpln.slot_block_reduce(
                tocc, BLOCK_T).sum())


def test_decode_operands_equal(rng):
    """score_operand / value_operands carry JAX's metadata."""
    e, g, hd = 4, 3, 16
    *_, (jc, tc) = _fill(rng, [20, 1])
    sched = tpln.kv_decode_slots(tskv.occupancy_mask(tc),
                                 tkvc.key_positions(tc), tc.pos - 1, 8)
    jsched = jnp.asarray(sched.numpy())
    k_e = rng.normal(size=(e, CAP, hd)).astype(np.float32)
    p = rng.random((e, g, CAP)).astype(np.float32) * sched.numpy()
    for tx, jx in ((tskv.score_operand(torch.from_numpy(k_e), sched, 16),
                    jskv.score_operand(jnp.asarray(k_e), jsched, 16)),):
        _eq_words(tx.bitmap, jx.bitmap)
        _eq(tx.slice_act, jx.slice_act)
        assert tx.slice_k == jx.slice_k
    occ = tskv.occupancy_mask(tc)
    tx, tw = tskv.value_operands(occ, torch.from_numpy(p),
                                 torch.from_numpy(k_e), sched, BLOCK_T)
    jx, jw = jskv.value_operands(jnp.asarray(occ.numpy()), jnp.asarray(p),
                                 jnp.asarray(k_e), jsched, BLOCK_T)
    _eq_words(tx.bitmap, jx.bitmap)
    _eq(tx.slice_act, jx.slice_act)
    _eq(tw.slice_act, jw.slice_act)
    assert (tx.slice_k, tw.slice_k) == (jx.slice_k, jw.slice_k)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def _jax_taped(fn, *args):
    """``fn(*args)`` (JAX) compiled with ``jax.jit``, and its stats tape:
    the entries recorded while it traces (names, StepCounts, executed
    steps) come back as outputs of the compiled call, so the tape holds
    the values an eager call records op by op, at a fraction of the eager
    run's time."""
    names = []

    def traced(*a):
        with jtape.collect() as entries:
            out = fn(*a)
        names[:] = [e[0] for e in entries]
        return out, [e[1:] for e in entries]
    out, rest = jax.jit(traced)(*args)
    return out, [(name, *r) for name, r in zip(names, rest)]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("knobs", [
    dict(), dict(sparse_use_kernel=True),
    dict(sparse_use_kernel=True, sparse_kcondense=True)],
    ids=["plain", "kernel", "kernel+kc"])
def test_attend_sparse_matches_jax(rng, window, knobs):
    jcfg, tcfg = _cfgs(window, **knobs)
    *_, (jc, tc) = _fill(rng, [20, 1, 1])
    q = rng.normal(size=(2, 1, 6, 16)).astype(np.float32)
    qpos = tc.pos - 1
    w = window or None
    jy, je = _jax_taped(lambda q_, c_: jattn.attend_sparse(
        q_, c_, jcfg, qpos=jnp.asarray([qpos], jnp.int32),
        kpos=jkvc.key_positions(c_), window=w), jnp.asarray(q), jc)
    with ttape.collect() as te:
        ty = tattn.attend_sparse(torch.from_numpy(q), tc, tcfg,
                                 qpos=torch.tensor([qpos]),
                                 kpos=tkvc.key_positions(tc), window=w)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    tsum, jsum = ttape.summarize(te), jtape.summarize(je)
    assert tsum == jsum
    assert [e["name"] for e in tsum] == ["attn.score", "attn.value"]
    for e in tsum:
        assert e["sparse_steps"] < e["dense_steps"]
        if knobs:
            assert e["executed_steps"] == e["sparse_steps"]
    # and the port's dense attend over the same cache agrees
    kd, vd, kpos = tkvc.read(tc, dtype=torch.float32)
    dense = tattn.attend(torch.from_numpy(q), kd, vd,
                         qpos=torch.tensor([qpos]), kpos=kpos, window=w)
    np.testing.assert_allclose(ty.numpy(), dense.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_init_caches_picks_sparse_only_in_a_sparse_mode():
    _, tcfg = _cfgs()
    caches = ttfm.init_caches(tcfg, 2, CAP, device="cpu")
    assert all(isinstance(c, tskv.SparseKVCache) for c in caches)
    assert caches[0].window == CAP and caches[0].n_blocks == CAP // BLOCK_T
    dense = dataclasses.replace(tcfg, sparse_mode="dense")
    assert not any(isinstance(c, tskv.SparseKVCache)
                   for c in ttfm.init_caches(dense, 2, CAP, device="cpu"))
    # a sliding-window model keeps the full capacity (the window is a mask)
    _, swa = _cfgs(window=8)
    assert ttfm.init_caches(swa, 2, CAP, device="cpu")[0].capacity == CAP


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    p, _ = jtfm.init_model(jax.random.PRNGKey(0), jsmoke(ARCH))
    p = jax.tree_util.tree_map(lambda a: np.array(a), p)
    p["layers"]["pos0"]["mlp"]["w_up"][:, :, :128] = 0
    model = convert.from_jax_params(p, tsmoke(ARCH), device="cpu")
    tokens = np.random.default_rng(1).integers(0, 512, (2, 5)).astype(
        np.int32)
    return p, model, tokens


def _jax_generate(params, batch, jcfg, **kwargs):
    """JAX ``generate`` compiled whole with ``jax.jit``: its decode steps
    are a compiled scan already, and this compiles its prefill with them
    instead of running it op by op."""
    return jax.jit(lambda p, b: jserve.generate(p, b, jcfg, **kwargs))(
        params, batch)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("knobs", [
    dict(), dict(sparse_use_kernel=True),
    dict(sparse_use_kernel=True, sparse_kcondense=True)],
    ids=["plain", "kernel", "kernel+kc"])
@pytest.mark.parametrize("max_new", [0, 1, 2, 8])
def test_generate_tokens_match_jax(setup, window, knobs, max_new):
    params, model, tokens = setup
    jcfg, tcfg = _cfgs(window, **knobs)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jt = _jax_generate(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                       max_new_tokens=max_new, capacity=CAP,
                       rc=JRunConfig(act_dtype="float32"))
    with ttape.collect() as te:
        tt = tserve.generate(model, {"tokens": torch.from_numpy(tokens)},
                             tcfg, max_new_tokens=max_new, capacity=CAP,
                             rc=TRunConfig(act_dtype="float32"),
                             device="cpu")
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (2, max_new)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # every decode step ran the bitmap-scheduled attention in each layer
    names = [e["name"] for e in ttape.summarize(te)]
    decodes = max(max_new - 1, 0)
    assert names.count("attn.score") == names.count("attn.value") \
        == 2 * decodes
