"""Paged serving pieces against the JAX package, on the same numpy inputs.

The paged KV pool (``PagedSparseKVCache`` and its functions) over a
sequence of inserts and decode appends with block tables, padding past a
prefill's true length, an idle slot writing the trash page and a ring
wrap; per-row cursors in ``written_slot_mask``/``key_positions_at``;
``kv_blocks_reclaimable``; ``apply_rope`` and ``attend`` with (B, S)
positions; ``attend_sparse`` over a paged cache; and the host-side
``PageAllocator``, ``Scheduler`` and ``pack_prefills`` on seeded
sequences.  Integer metadata is bit-equal, K/V values equal, float32
attention within 1e-4 and bf16 within 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import attention as jattn
from repro.models import cache as jkvc
from repro.models import transformer as jtfm
from repro.serving import scheduler as jsch
from repro.sparse import kvcache as jskv
from repro.sparse import plan as jpln
from repro.sparse import tape as jtape
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models import attention as tattn
from repro_torch.models import cache as tkvc
from repro_torch.models import transformer as ttfm
from repro_torch.serving import scheduler as tsch
from repro_torch.sparse import kvcache as tskv
from repro_torch.sparse import plan as tpln
from repro_torch.sparse import tape as ttape

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

ARCH = "nemotron-4-340b"
SLOTS, PAGES, PAGE, CAP, KVH, HD = 3, 6, 8, 24, 2, 4


def _eq(t, j):
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        t, j = t.float(), jnp.asarray(j, jnp.float32)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _eq_words(t, j):
    np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j))


def _unstack(c):
    return jax.tree_util.tree_map(lambda a: a[0], c)


def _stack(c):
    return jax.tree_util.tree_map(lambda a: a[None], c)


class Pools:
    """One JAX pool (stacked over one layer, as the JAX engine holds it)
    and one port pool, driven by the same calls."""

    def __init__(self, dtype="float32"):
        self.jd, self.td = jnp.dtype(dtype), getattr(torch, dtype)
        self.j = jskv.init_paged_cache(SLOTS, PAGES, PAGE, CAP, KVH, HD,
                                       stack=(1,), dtype=self.jd)
        self.t = tskv.init_paged_cache(SLOTS, PAGES, PAGE, CAP, KVH, HD,
                                       dtype=self.td, device="cpu")
        self.table = np.zeros((SLOTS, CAP // PAGE), np.int32)

    def push_table(self):
        self.j = self.j._replace(table=jnp.asarray(self.table)[None])
        self.t = dataclasses.replace(self.t,
                                     table=torch.from_numpy(self.table))

    def _pair(self, rng, shape):
        """The same random values as a JAX and a port array of the pool's
        dtype."""
        x = rng.normal(size=shape).astype(np.float32)
        return jnp.asarray(x, self.jd), torch.from_numpy(x).to(self.td)

    def insert(self, rng, tc, row, slot, pages, true_len):
        """A contiguous (2, tc) prefill cache's row into ``slot``."""
        jk, tk = self._pair(rng, (2, tc, KVH, HD))
        jv, tv = self._pair(rng, (2, tc, KVH, HD))
        jpre = jkvc.init_cache(2, tc, KVH, HD, stack=(1,), dtype=self.jd)
        jpre = jpre._replace(k=jk[None], v=jv[None])
        tpre = tkvc.KVCache(k=tk, v=tv, pos=tc, window=tc)
        self.j = jskv.insert_prefill(self.j, jpre, jnp.int32(row),
                                     jnp.int32(slot),
                                     jnp.asarray(pages, jnp.int32),
                                     jnp.int32(true_len))
        self.t = tskv.insert_prefill(self.t, tpre, row, slot, pages,
                                     true_len)
        self.table[slot] = 0
        self.table[slot, :len(pages)] = pages
        self.push_table()

    def append(self, rng):
        jk, tk = self._pair(rng, (SLOTS, 1, KVH, HD))
        jv, tv = self._pair(rng, (SLOTS, 1, KVH, HD))
        self.j = _stack(jskv.paged_update(_unstack(self.j), jk, jv))
        self.t = tskv.paged_update(self.t, tk, tv)

    def check(self):
        j, t = _unstack(self.j), self.t
        _eq(t.pos, j.pos)
        _eq(t.table, j.table)
        _eq(t.blk, j.blk)
        _eq_words(t.occ, j.occ)
        assert (t.page_size, t.n_pages, t.n_slots, t.n_blocks,
                t.capacity) == (j.page_size, j.n_pages, j.n_slots,
                                j.n_blocks, j.capacity)
        _eq(t.k, j.k)
        _eq(t.v, j.v)
        _eq(tskv.paged_occupancy_mask(t), jskv.paged_occupancy_mask(j))
        _eq(tskv.paged_key_positions(t), jskv.paged_key_positions(j))
        tk, tv = tskv.paged_view(t)
        jk, jv, _, _ = jskv.paged_view(j)
        _eq(tk, jk)
        _eq(tv, jv)
        for dt in (torch.float32, torch.bfloat16):
            tk, tv = tskv.paged_read(t, dtype=dt)
            jk, jv = jskv.paged_read(j, dtype=jnp.dtype(str(dt)[6:]))
            _eq(tk, jk)
            _eq(tv, jv)
        for mw in (None, 5):
            trep = tskv.paged_occupancy_report(t, mask_window=mw)
            jrep = jskv.paged_occupancy_report(self.j, mask_window=mw)
            assert trep == {k: jrep[k] for k in trep}, (trep, jrep)


def _drive(rng, pools):
    """Slot 0: 11 tokens in pages 2, 5 (a prefill padded to 16 rows, the
    last page holding padding past the true length), later page 3; slot
    1 idle, its writes landing in trash page 0 alone; slot 2: 20 tokens
    from a 17-row prefill zero-padded to its three pages 1, 4, 6, then
    decode past the capacity (ring wrap into page 1)."""
    pools.check()
    pools.insert(rng, 16, 1, 0, [2, 5], 11)
    pools.check()
    pools.insert(rng, 17, 0, 2, [1, 4, 6], 20)
    pools.check()
    for step in range(7):
        if step == 5:   # slot 0's cursor reaches block 2 (16)
            pools.table[0, 2] = 3
            pools.push_table()
        pools.append(rng)
        pools.check()
        yield pools


@pytest.fixture(scope="module")
def driven():
    """Pools driven through :func:`_drive` once, checked at every step."""
    pools = Pools()
    for _ in _drive(np.random.default_rng(0), pools):
        pass
    return pools


def test_paged_pool_matches_jax(driven):
    t = driven.t
    assert t.pos.tolist() == [18, 7, 27]           # slot 2 wrapped past 24
    assert t.blk.tolist()[2] == [8, 8, 8]


def test_paged_pool_bf16_matches_jax(rng):
    pools = Pools("bfloat16")
    for _ in _drive(rng, pools):
        pass


def test_paged_pool_geometry_refused():
    with pytest.raises(ValueError, match="multiple of the page size"):
        tskv.init_paged_cache(1, 2, 8, 20, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="single-token"):
        c = tskv.init_paged_cache(1, 2, 8, 16, 1, 4, device="cpu")
        tskv.paged_update(c, torch.zeros(1, 2, 1, 4), torch.zeros(1, 2, 1, 4))


# ---------------------------------------------------------------------------
# per-row cursors and the reclaim predicate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [24, 10])
@pytest.mark.parametrize("s", [1, 3])
def test_per_row_cursor_masks(window, s):
    pos = np.array([0, 1, 9, 23, 24, 31], np.int32)
    got = tkvc.written_slot_mask(torch.from_numpy(pos), window, CAP, s)
    assert tuple(got.shape) == (len(pos), CAP)
    _eq(got, jkvc.written_slot_mask(jnp.asarray(pos), jnp.int32(window),
                                    CAP, s))
    got = tkvc.key_positions_at(torch.from_numpy(pos), window, CAP)
    _eq(got, jkvc.key_positions_at(jnp.asarray(pos), jnp.int32(window),
                                   CAP))
    # each row equals the shared-cursor form at that cursor
    for r, p in enumerate(pos.tolist()):
        _eq(got[r], tkvc.key_positions_at(p, window, CAP))


@pytest.mark.parametrize("pos,window,block_t,n_blocks", [
    (0, 0, 8, 4), (40, 0, 8, 6), (23, 16, 8, 4), (24, 16, 8, 4),
    (47, 16, 32, 2), (48, 16, 32, 2), (100, 33, 8, 16), (5, 64, 32, 2)])
def test_kv_blocks_reclaimable(pos, window, block_t, n_blocks):
    assert tpln.kv_blocks_reclaimable(pos, window, block_t, n_blocks) == \
        jpln.kv_blocks_reclaimable(pos, window, block_t, n_blocks)


# ---------------------------------------------------------------------------
# per-row positions in rope and attend
# ---------------------------------------------------------------------------

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("style", ["half", "2d"])
def test_apply_rope_per_row_positions(rng, dtype, style):
    x = rng.normal(size=(3, 2, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1], [7, 8], [30, 31]], np.int32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jattn.apply_rope(jx, jnp.asarray(pos), style, 10000.0)
    got = tattn.apply_rope(tx, torch.from_numpy(pos), style, 10000.0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    # a row's positions through the shared (S,) form give that row
    shared = tattn.apply_rope(tx[1:2], torch.from_numpy(pos[1]), style,
                              10000.0)
    torch.testing.assert_close(got[1:2], shared, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_attend_per_row_positions(rng, dtype, window):
    b, skv, h, kvh, hd = 3, 12, 4, 2, 8
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kvh, hd)).astype(np.float32)
    qpos = np.array([[3], [11], [7]], np.int32)
    kpos = np.stack([np.where(np.arange(skv) <= p, np.arange(skv), -1)
                     for p in qpos[:, 0]]).astype(np.int32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jattn.attend(jnp.asarray(q, jd), jnp.asarray(k, jd),
                        jnp.asarray(v, jd), qpos=jnp.asarray(qpos),
                        kpos=jnp.asarray(kpos), window=window)
    got = tattn.attend(torch.from_numpy(q).to(td),
                       torch.from_numpy(k).to(td),
                       torch.from_numpy(v).to(td),
                       qpos=torch.from_numpy(qpos),
                       kpos=torch.from_numpy(kpos), window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("knobs", [
    dict(), dict(sparse_use_kernel=True),
    dict(sparse_use_kernel=True, sparse_kcondense=True)],
    ids=["plain", "kernel", "kernel+kc"])
def test_attend_sparse_paged_matches_jax(rng, driven, window, knobs):
    """The paged branch: the logical view, per-slot (B, T) schedules
    expanded to (E, T), equal tapes and outputs within 1e-4."""
    knobs = dict(sparse_mode="dual", sparse_block_t=PAGE, **knobs)
    jcfg = dataclasses.replace(jsmoke(ARCH), n_kv_heads=KVH, **knobs)
    tcfg = dataclasses.replace(tsmoke(ARCH), n_kv_heads=KVH, **knobs)
    j, t = _unstack(driven.j), driven.t
    h = 6
    q = rng.normal(size=(SLOTS, 1, h, HD)).astype(np.float32)
    qpos = (t.pos - 1).clamp(min=0)[:, None]
    with jtape.collect() as je:
        jy = jattn.attend_sparse(jnp.asarray(q), j, jcfg,
                                 qpos=jnp.asarray(qpos.numpy()),
                                 kpos=jskv.paged_key_positions(j),
                                 window=window)
    with ttape.collect() as te:
        ty = tattn.attend_sparse(torch.from_numpy(q), t, tcfg, qpos=qpos,
                                 kpos=tskv.paged_key_positions(t),
                                 window=window)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    tsum = ttape.summarize(te)
    assert tsum == jtape.summarize(je)
    assert [e["name"] for e in tsum] == ["attn.score", "attn.value"]
    # and the dense attend over the logical view agrees
    kd, vd = tskv.paged_read(t, dtype=torch.float32)
    dense = tattn.attend(torch.from_numpy(q), kd, vd, qpos=qpos,
                         kpos=tskv.paged_key_positions(t), window=window)
    np.testing.assert_allclose(ty.numpy(), dense.numpy(), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# caches of the engine
# ---------------------------------------------------------------------------

def test_init_caches_full_history_and_paged():
    jcfg = dataclasses.replace(jsmoke(ARCH), sliding_window=8)
    tcfg = dataclasses.replace(tsmoke(ARCH), sliding_window=8)
    for full in (False, True):
        jc = jtfm.init_caches(jcfg, 2, 24, sparse=False, full_history=full)
        tc = ttfm.init_caches(tcfg, 2, 24, sparse=False, full_history=full,
                              device="cpu")
        jkv = jc["pos0"]["kv"]
        assert len(tc) == tcfg.n_layers
        assert tc[0].capacity == jkv.capacity
        assert tc[0].window == int(jkv.window[0])
        assert not isinstance(tc[0], tskv.SparseKVCache)
    kv = dataclasses.replace(tcfg, sparse_mode="dual", sparse_kv=True)
    assert isinstance(ttfm.init_caches(kv, 2, 24, device="cpu")[0],
                      tskv.SparseKVCache)
    assert not isinstance(ttfm.init_caches(kv, 2, 24, sparse=False,
                                           device="cpu")[0],
                          tskv.SparseKVCache)
    jp = jtfm.init_paged_caches(jcfg, 3, 5, 8, 24)["pos0"]["kv"]
    tp = ttfm.init_paged_caches(tcfg, 3, 5, 8, 24, device="cpu")
    assert len(tp) == tcfg.n_layers
    for c in tp:
        assert tuple(c.k.shape) == jp.k.shape[1:]
        _eq(c.table, jp.table[0])
        _eq_words(c.occ, jp.occ[0])
    whisper = tsmoke("whisper-base")
    with pytest.raises(ValueError, match="decoder-only"):
        ttfm.init_paged_caches(whisper, 2, 4, 8, 16, device="cpu")


# ---------------------------------------------------------------------------
# the host-side scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Req:
    uid: int
    prompt: list
    not_before: int = 0


def test_page_allocator_matches_jax():
    rng = np.random.default_rng(5)
    ja, ta = jsch.PageAllocator(12), tsch.PageAllocator(12)
    held = []
    for _ in range(200):
        if held and rng.random() < 0.45:
            pages = held.pop(int(rng.integers(len(held))))
            ja.free(pages)
            ta.free(pages)
        else:
            n = int(rng.integers(1, 5))
            got = ta.alloc(n)
            assert got == ja.alloc(n)
            if got is not None:
                held.append(got)
        assert ta.available == ja.available
        assert list(ta._free) == list(ja._free)
    assert ta.check() == ja.check()
    for bad in ([0], [13], list(ta._free)[:1]):
        with pytest.raises(ValueError):
            ta.free(bad)
        with pytest.raises(ValueError):
            ja.free(bad)
    for n in (0, -1):
        with pytest.raises(ValueError):
            ta.alloc(n)


@pytest.mark.parametrize("policy", ["fcfs", "cost"])
def test_scheduler_matches_jax(policy):
    rng = np.random.default_rng(7)

    def cost(r):
        return float(sum(r.prompt) % 17)
    js = jsch.Scheduler(policy, cost_fn=cost)
    ts = tsch.Scheduler(policy, cost_fn=cost)
    uid = 0
    for tick in range(120):
        op = rng.random()
        if op < 0.4:
            r = Req(uid, list(rng.integers(1, 50, int(rng.integers(1, 9)))),
                    not_before=int(rng.integers(0, tick + 3)))
            uid += 1
            js.submit(r)
            ts.submit(r)
        elif op < 0.55 and len(ts):
            r = ts.queue[-1]
            js.queue.remove(r)
            ts.queue.remove(r)
            js.requeue(r)
            ts.requeue(r)
        elif op < 0.85:
            mp = int(rng.integers(0, 6))
            kw = dict(max_pages=mp, pages_of=lambda r: -(-len(r.prompt) // 3),
                      now=tick) if rng.random() < 0.7 else {}
            a, b = ts.pop_next(**kw), js.pop_next(**kw)
            assert (a and a.uid) == (b and b.uid)
        else:
            rows = [(s, Req(int(u), [int(u)] * 3), int(t)) for s, (u, t) in
                    enumerate(rng.integers(0, 40, (int(rng.integers(0, 4)),
                                                   2)))]
            assert ts.pick_victim(rows) == js.pick_victim(rows)
        assert [r.uid for r in ts.queue] == [r.uid for r in js.queue]
    assert ts._cost == js._cost
    with pytest.raises(ValueError, match="unknown policy"):
        tsch.Scheduler("lifo")


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("bucket,max_batch", [(8, 4), (32, 2), (1, 3)])
def test_pack_prefills_matches_jax(pack, bucket, max_batch):
    rng = np.random.default_rng(11)
    reqs = [Req(i, [1] * int(n)) for i, n in
            enumerate(rng.integers(1, 70, 13))]
    kw = dict(bucket=bucket, max_batch=max_batch, pack=pack)
    got = tsch.pack_prefills(reqs, **kw)
    want = jsch.pack_prefills(reqs, **kw)
    assert [(lp, [r.uid for r in g]) for lp, g in got] == \
        [(lp, [r.uid for r in g]) for lp, g in want]
    longer = tsch.pack_prefills(reqs, length_of=lambda r: len(r.prompt) + 5,
                                **kw)
    assert [(lp, [r.uid for r in g]) for lp, g in longer] == \
        [(lp, [r.uid for r in g]) for lp, g in jsch.pack_prefills(
            reqs, length_of=lambda r: len(r.prompt) + 5, **kw)]
