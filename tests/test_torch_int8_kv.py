"""int8 KV caches and KV-chunked attention against the JAX package, on
the same numpy inputs.

* ``_quantize``: int8 codes bit-equal (half to even included), scales
  within 1e-7 relative;
* ``attend`` over a capacity of four chunks (the log-sum-exp loop) and
  over one that is no multiple of the chunk (the single block), bf16 and
  int8 K/V, shared and per-row key positions, float32 within 1e-4;
* plain, sparse and paged int8 caches written by the same prefills and
  decode appends: codes bit-equal, scales within 1e-7, reads equal;
* ``qwen1.5-110b-smoke`` (qkv bias, random biases) on int8 caches: plain
  caches in dense mode and sparse caches in dual+kv, prefill then decode
  step by step, codes bit-equal, scales and float32 logits within 1e-4;
  ``generate`` with ``rc.kv_quant`` in dual+kv and the ``Engine`` on an
  int8 pool, greedy tokens identical.

The JAX serve loop and engine run their XLA path
(``sparse_use_kernel=False``), as in ``test_torch_engine.py``.  The JAX
``attend`` and ``paged_read`` run under ``jax.jit``, as every served path
runs them: compiled, XLA keeps the product of an int8 code and its bf16
scale unrounded in float32, which eager JAX rounds to bf16 first.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.models import attention as jattn
from repro.models import cache as jkvc
from repro.models import transformer as jtfm
from repro.serving import engine as jeng
from repro.serving import serve_loop as jserve
from repro.sparse import kvcache as jskv
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.models import attention as tattn
from repro_torch.models import cache as tkvc
from repro_torch.models import convert
from repro_torch.models import transformer as ttfm
from repro_torch.serving import engine as teng
from repro_torch.serving import serve_loop as tserve
from repro_torch.sparse import kvcache as tskv

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

ARCH = "qwen1.5-110b"
DUAL_KV = dict(sparse_mode="dual", sparse_use_kernel=True, sparse_kv=True,
               sparse_block_t=8)
PROMPT, NEW = 10, 6
JRC = JRunConfig(act_dtype="float32", kv_quant=True)
TRC = TRunConfig(act_dtype="float32", kv_quant=True)


def _eq(t, j):
    if t.dtype == torch.bfloat16:
        t, j = t.float(), jnp.asarray(j, jnp.float32)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _scales(t, j, rtol=1e-7):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=0)


# the JAX functions as the served paths run them: compiled
_jattend = jax.jit(jattn.attend, static_argnames=("window", "chunk"))
_jpaged_read = jax.jit(jskv.paged_read, static_argnames=("dtype",))


def _pair(x, dtype):
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


# ---------------------------------------------------------------------------
# _quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_codes_bit_equal(rng, dtype):
    x = (rng.normal(size=(2, 7, 3, 16)) * rng.uniform(
        0.01, 30, size=(2, 7, 3, 1))).astype(np.float32)
    # absmax 127 makes the scale exactly 1: halves round to even; an all
    # zero row takes the 1e-6 floor
    x[0, 0, 0] = [127, .5, 1.5, 2.5, -.5, -1.5, -2.5, 3.5, 126.5, -126.5,
                  0, 1, -1, 4.5, 5.5, -127]
    x[0, 0, 1] = 0
    jx, tx = _pair(x, dtype)
    jq, js = jkvc._quantize(jx)
    tq, ts = tkvc._quantize(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _eq(tq, jq)
    _scales(ts, js)
    assert tq[0, 0, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126, -126,
                                    0, 1, -1, 4, 6, -127]
    assert not tq[0, 0, 1].any()


# ---------------------------------------------------------------------------
# attend: the chunked loop and the single block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("skv", [32, 30])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_attend_chunked_matches_jax(rng, kv, skv, per_row):
    """chunk 8: Skv 32 runs four chunks, Skv 30 one block.  Three queries
    at the end of the stream, a window of 10, the last two slots empty;
    per-row key positions shift row 1's stream by 3."""
    b, sq, h, kvh, hd, chunk = 2, 3, 4, 2, 16, 8
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    if kv == "int8":
        k = rng.integers(-127, 128, (b, skv, kvh, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (b, skv, kvh, hd)).astype(np.int8)
        ks, vs = (rng.uniform(1e-3, 2e-2, (b, skv, kvh, 1)).astype(
            np.float32) for _ in range(2))
        jk, jv, tk, tv = (jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k),
                          torch.from_numpy(v))
        jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tsc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    else:
        jk, tk = _pair(rng.normal(size=(b, skv, kvh, hd)).astype(np.float32),
                       kv)
        jv, tv = _pair(rng.normal(size=(b, skv, kvh, hd)).astype(np.float32),
                       kv)
        jsc, tsc = {}, {}
    kpos = np.arange(skv, dtype=np.int32)
    kpos[-2:] = -1
    qpos = np.arange(skv - 2 - sq, skv - 2, dtype=np.int32)
    if per_row:
        kpos = np.stack([kpos, np.where(kpos >= 3, kpos - 3, -1)])
        qpos = np.stack([qpos, qpos - 3])
    jout = _jattend(jnp.asarray(q), jk, jv, qpos=jnp.asarray(qpos),
                    kpos=jnp.asarray(kpos), window=10, chunk=chunk, **jsc)
    args = dict(qpos=torch.from_numpy(qpos), kpos=torch.from_numpy(kpos),
                window=10, **tsc)
    tout = tattn.attend(torch.from_numpy(q), tk, tv, chunk=chunk, **args)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=1e-4)
    # the loop and the single block agree with each other too
    whole = tattn.attend(torch.from_numpy(q), tk, tv, chunk=0, **args)
    torch.testing.assert_close(tout, whole, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the caches, written by the same values
# ---------------------------------------------------------------------------

def _check_cache(t, j):
    _eq(t.k, j.k)
    _eq(t.v, j.v)
    _scales(t.k_scale, j.k_scale)
    _scales(t.v_scale, j.v_scale)
    assert t.pos == int(j.pos) and t.quantized and j.quantized
    for dt in (torch.float32, torch.bfloat16):
        for got, want in zip(tkvc.read(t, dtype=dt),
                             jkvc.read(j, dtype=jnp.dtype(str(dt)[6:]))):
            _eq(got, want)


@pytest.mark.parametrize("kind", ["plain", "ring", "sparse"])
def test_int8_caches_bit_equal(rng, kind):
    """A 5-token prefill and 6 decode appends; ``ring`` is an 8-slot ring
    that wraps, ``sparse`` a SparseKVCache with its occupancy."""
    b, cap, kvh, hd = 2, 16, 2, 8
    window = 8 if kind == "ring" else 0
    cap = 8 if kind == "ring" else cap
    if kind == "sparse":
        j = jskv.init_sparse_cache(b, cap, kvh, hd, quantized=True,
                                   block_t=4)
        t = tskv.init_sparse_cache(b, cap, kvh, hd, quantized=True,
                                   block_t=4, device="cpu")
        jup, tup = jskv.update, tskv.update
    else:
        j = jkvc.init_cache(b, cap, kvh, hd, quantized=True, window=window)
        t = tkvc.init_cache(b, cap, kvh, hd, quantized=True, window=window,
                            device="cpu")
        jup, tup = jkvc.update, tkvc.update
    _check_cache(t, j)
    for s in (5, 1, 1, 1, 1, 1, 1):
        jk, tk = _pair(rng.normal(size=(b, s, kvh, hd)).astype(np.float32),
                       "float32")
        jv, tv = _pair(rng.normal(size=(b, s, kvh, hd)).astype(np.float32),
                       "float32")
        j, t = jup(j, jk, jv), tup(t, tk, tv)
        _check_cache(t, j)
        if kind == "sparse":
            _eq(t.blk, j.blk)
            np.testing.assert_array_equal(t.occ.numpy().view(np.uint32),
                                          np.asarray(j.occ))


def test_int8_paged_pool_bit_equal(rng):
    """An int8 prefill cache's rows into pool pages (one page padded past
    the true length), then decode appends on every slot, an idle one into
    the trash page: codes, scales, the gathered view and its reads."""
    slots, pages, page, cap, kvh, hd = 3, 6, 4, 12, 2, 8
    j = jskv.init_paged_cache(slots, pages, page, cap, kvh, hd, stack=(1,),
                              quantized=True)
    t = tskv.init_paged_cache(slots, pages, page, cap, kvh, hd,
                              quantized=True, device="cpu")
    jpre = jkvc.init_cache(2, 8, kvh, hd, stack=(1,), quantized=True)
    tpre = tkvc.init_cache(2, 8, kvh, hd, quantized=True, device="cpu")
    x = rng.normal(size=(2, 2, 7, kvh, hd)).astype(np.float32)
    jpre = jax.tree_util.tree_map(lambda a: a[None], jkvc.update(
        jax.tree_util.tree_map(lambda a: a[0], jpre), jnp.asarray(x[0]),
        jnp.asarray(x[1])))
    tpre = tkvc.update(tpre, torch.from_numpy(x[0]), torch.from_numpy(x[1]))
    table = np.zeros((slots, cap // page), np.int32)
    for row, slot, pg, true_len in ((0, 0, [2, 5], 7), (1, 2, [1], 3)):
        j = jskv.insert_prefill(j, jpre, jnp.int32(row), jnp.int32(slot),
                                jnp.asarray(pg, jnp.int32),
                                jnp.int32(true_len))
        t = tskv.insert_prefill(t, tpre, row, slot, pg, true_len)
        table[slot, :len(pg)] = pg
    table[2, 1] = 3
    j = j._replace(table=jnp.asarray(table)[None])
    t = dataclasses.replace(t, table=torch.from_numpy(table.copy()))
    for _ in range(3):
        y = rng.normal(size=(2, slots, 1, kvh, hd)).astype(np.float32)
        j = jax.tree_util.tree_map(lambda a: a[None], jskv.paged_update(
            jax.tree_util.tree_map(lambda a: a[0], j), jnp.asarray(y[0]),
            jnp.asarray(y[1])))
        t = tskv.paged_update(t, torch.from_numpy(y[0]),
                              torch.from_numpy(y[1]))
        ju = jax.tree_util.tree_map(lambda a: a[0], j)
        _eq(t.k, ju.k)
        _eq(t.v, ju.v)
        _scales(t.k_scale, ju.k_scale)
        _scales(t.v_scale, ju.v_scale)
        _eq(t.pos, ju.pos)
        for got, want in zip(tskv.paged_view(t, scales=True),
                             jskv.paged_view(ju)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-7, atol=0)
        for dt in (torch.float32, torch.bfloat16):
            for got, want in zip(tskv.paged_read(t, dtype=dt),
                                 _jpaged_read(ju,
                                              dtype=jnp.dtype(str(dt)[6:]))):
                _eq(got, want)
    rep = tskv.paged_occupancy_report(t)
    assert rep["quantized"] is True
    assert rep == {k: v for k, v in jskv.paged_occupancy_report(j).items()
                   if k in rep}


# ---------------------------------------------------------------------------
# the model on int8 caches
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _weights():
    """JAX ``init_model`` parameters with random qkv biases (JAX starts
    them at zero), as JAX arrays, and the port's model on them."""
    p, _ = jtfm.init_model(jax.random.PRNGKey(0), jsmoke(ARCH))
    p = jax.tree_util.tree_map(lambda a: np.array(a), p)
    rng = np.random.default_rng(3)
    attn = p["layers"]["pos0"]["attn"]
    for key in ("bq", "bk", "bv"):
        attn[key] = (0.5 * rng.normal(size=attn[key].shape)).astype(
            np.float32)
    model = convert.from_jax_params(p, tsmoke(ARCH), device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, p), model


def _tokens():
    return np.random.default_rng(1).integers(0, 512, (2, PROMPT)).astype(
        np.int32)


def _cfgs(**knobs):
    """(JAX config on its XLA path, port config)."""
    return (dataclasses.replace(jsmoke(ARCH),
                                **dict(knobs, sparse_use_kernel=False)),
            dataclasses.replace(tsmoke(ARCH), **knobs))


def _check_layer_caches(tcaches, jcaches, sparse):
    jkv = jcaches["pos0"]["kv"]
    for i, t in enumerate(tcaches):
        assert isinstance(t, tskv.SparseKVCache) == sparse and t.quantized
        j = jax.tree_util.tree_map(lambda a: a[i], jkv)
        _eq(t.k, j.k)
        _eq(t.v, j.v)
        _scales(t.k_scale, j.k_scale, rtol=1e-4)
        _scales(t.v_scale, j.v_scale, rtol=1e-4)


@pytest.mark.parametrize("mode", ["dense", "dual+kv"])
def test_int8_steps_match_jax(mode):
    """Prefill into int8 caches (plain in dense mode, sparse in dual+kv),
    then decode steps: logits, tokens, codes and scales."""
    jparams, model = _weights()
    jcfg, tcfg = _cfgs(**(DUAL_KV if mode == "dual+kv" else {}))
    tokens = _tokens()
    cap = PROMPT + NEW
    jstate, jl = jserve.make_prefill_step(jcfg, JRC)(
        jparams, {"tokens": jnp.asarray(tokens)},
        jtfm.init_caches(jcfg, 2, cap, quantized=True))
    tstate, tl = tserve.make_prefill_step(tcfg, TRC)(
        model, {"tokens": torch.from_numpy(tokens).long()},
        ttfm.init_caches(tcfg, 2, cap, quantized=True, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _check_layer_caches(tstate.caches, jstate.caches, mode == "dual+kv")
    jdec = jserve.make_decode_step(jcfg, JRC)
    tdec = tserve.make_decode_step(tcfg, TRC)
    for _ in range(NEW - 1):
        jstate, jl = jdec(jparams, jstate)
        tstate, tl = tdec(model, tstate)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(tstate.last_token.numpy(),
                                      np.asarray(jstate.last_token))
    _check_layer_caches(tstate.caches, jstate.caches, mode == "dual+kv")


def test_generate_kv_quant_matches_jax():
    """``generate`` builds int8 caches from ``rc.kv_quant``: dual+kv."""
    jparams, model = _weights()
    jcfg, tcfg = _cfgs(**DUAL_KV)
    tokens = _tokens()
    jt = jserve.generate(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                         max_new_tokens=NEW, rc=JRC)
    tt = tserve.generate(model, {"tokens": torch.from_numpy(tokens)}, tcfg,
                         max_new_tokens=NEW, rc=TRC, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_engine_kv_quant_matches_jax():
    """Three staggered requests through both engines on int8 pools
    (dual+kv), two slots: tokens request for request, pool metadata."""
    jparams, model = _weights()
    jcfg, tcfg = _cfgs(**DUAL_KV)
    serve = dict(slots=2, capacity=32)
    je = jeng.Engine(jparams, jcfg, serve=JServeConfig(**serve), rc=JRC)
    te = teng.Engine(model, tcfg, serve=TServeConfig(**serve), rc=TRC,
                     device="cpu")
    assert te.quantized and je.quantized
    assert all(c.quantized for c in te.caches)
    prompts = [[5, 6, 7, 8, 9, 10, 11], [11, 3, 9, 2, 4], [8, 1, 2]]
    done = {}
    for eng, mod in ((je, jeng), (te, teng)):
        out = []
        for uid, prompt in enumerate(prompts):
            eng.submit(mod.Request(uid=uid, prompt=list(prompt),
                                   max_new_tokens=8))
            out.extend(eng.step())
        out.extend(eng.run_to_completion())
        done[mod] = {r.uid: list(r.output) for r in out}
    assert done[teng] == done[jeng]
    assert all(len(t) == 8 for t in done[teng].values())
    assert te.pool_stats() == {k: v for k, v in je.pool_stats().items()
                               if k in te.pool_stats()}
