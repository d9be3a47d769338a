"""The continuous-batching engine against the JAX package's.

``nemotron-4-340b-smoke`` with the JAX parameters carried across by
``convert.from_jax_params`` (some of layer 0's MLP columns zeroed so the
sparse schedules skip), both engines in float32 activations: staggered
submissions, page recycling, preemption under page pressure and a
sliding-window model that reclaims window-dead pages, each in dense and in
dual + sparse KV, and ``stats()``.  Tokens are identical request for
request, the pools' metadata bit-equal, and the port's tokens equal its
own ``generate`` at batch 1.  The ``cost`` policy and ``profile_sparsity``
are in ``test_torch_engine_profile.py``.

The JAX engine runs its XLA path: its Pallas kernels in interpret mode
would take minutes here, and neither tokens nor schedules depend on them,
only the executed step counts (the port's kernel path executes the steps
it schedules, held against JAX's kernels in ``test_torch_kvcache.py``).
"""
import dataclasses

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
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.launch import serve as tlaunch
from repro_torch.models import convert
from repro_torch.serving import engine as teng
from repro_torch.serving import serve_loop as tserve

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

ARCH = "nemotron-4-340b"
DUAL_KV = dict(sparse_mode="dual", sparse_use_kernel=True, sparse_kv=True,
               sparse_block_t=8)
STAGGERED = [[5, 6, 7], [11, 3, 9, 2, 4], [8], [2, 2, 2, 2, 2, 2, 2]]
STAGGERED_KV = [[5, 6, 7], [11, 3, 9, 2, 4], [8, 1, 2, 3]]
# shared by both engines' stats(): the port has no *_traces counters
SHARED_STATS = ("ticks", "evictions", "prefill_calls", "decode_calls",
                "tokens_emitted", "errored", "pages_free", "pages_total")


@pytest.fixture(scope="module")
def setup():
    p, _ = jtfm.init_model(jax.random.PRNGKey(0), jsmoke(ARCH))
    p = jax.tree_util.tree_map(lambda a: np.array(a), p)
    p["layers"]["pos0"]["mlp"]["w_up"][:, :, :128] = 0
    model = convert.from_jax_params(p, tsmoke(ARCH), device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, p), model


def _cfgs(**knobs):
    """(JAX config on its XLA path, port config)."""
    return (dataclasses.replace(jsmoke(ARCH),
                                **dict(knobs, sparse_use_kernel=False)),
            dataclasses.replace(tsmoke(ARCH), **knobs))


def _engines(setup, serve, **knobs):
    """A JAX and a port engine on the same weights, float32 activations."""
    jparams, model = setup
    jcfg, tcfg = _cfgs(**knobs)
    je = jeng.Engine(jparams, jcfg, serve=JServeConfig(**serve),
                     rc=JRunConfig(act_dtype="float32"))
    te = teng.Engine(model, tcfg, serve=TServeConfig(**serve),
                     rc=TRunConfig(act_dtype="float32"), device="cpu")
    return je, te


def _serve(eng, mod, prompts, max_new, staggered):
    """Submit the prompts (one a tick while earlier ones decode when
    ``staggered``) and drain; returns {uid: request} and the finish
    order."""
    done = []
    for uid, p in enumerate(prompts):
        eng.submit(mod.Request(uid=uid, prompt=list(p),
                               max_new_tokens=max_new))
        if staggered:
            done.extend(eng.step())
    done.extend(eng.run_to_completion())
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    return {r.uid: r for r in done}, [r.uid for r in done]


def _both(setup, serve, prompts, max_new, staggered=False, **knobs):
    je, te = _engines(setup, serve, **knobs)
    jdone, jorder = _serve(je, jeng, prompts, max_new, staggered)
    tdone, torder = _serve(te, teng, prompts, max_new, staggered)
    return je, te, jdone, tdone, jorder, torder


def _generate(setup, prompt, max_new, capacity, **knobs):
    _, model = setup
    _, tcfg = _cfgs(**knobs)
    out = tserve.generate(model, {"tokens": torch.tensor([prompt])}, tcfg,
                          max_new_tokens=max_new, capacity=capacity,
                          rc=TRunConfig(act_dtype="float32"), device="cpu")
    return out[0].tolist()


def _shared(stats):
    return {k: stats[k] for k in SHARED_STATS}


def _pool_equal(je, te):
    """Every layer's pool metadata (cursors, block tables, occupancy
    words and block counts) bit-equal to the JAX engine's stacked pool."""
    jkv = je.caches["pos0"]["kv"]
    assert len(te.caches) == jkv.pos.shape[0]
    for i, c in enumerate(te.caches):
        np.testing.assert_array_equal(c.pos.numpy(), np.asarray(jkv.pos[i]))
        np.testing.assert_array_equal(c.table.numpy(),
                                      np.asarray(jkv.table[i]))
        np.testing.assert_array_equal(c.blk.numpy(), np.asarray(jkv.blk[i]))
        np.testing.assert_array_equal(c.occ.numpy().view(np.uint32),
                                      np.asarray(jkv.occ[i]))


# the cases below run in both served paths: dense attention over the
# gathered view, and dual + sparse KV (K1 + K3's plain walks here)
PATHS = {"dense": {}, "dual+kv": DUAL_KV}


@pytest.fixture(scope="module")
def staggered(setup):
    """Staggered arrivals through 2-slot engines, dense and dual + sparse
    KV (K1 + K3's plain walks on the port's side)."""
    runs = {}
    for name, prompts, knobs in (("dense", STAGGERED, {}),
                                 ("dual+kv", STAGGERED_KV, DUAL_KV)):
        runs[name] = (prompts, knobs) + _both(
            setup, dict(slots=2, capacity=32), prompts, 4, staggered=True,
            **knobs)
    return runs


@pytest.mark.parametrize("mode", ["dense", "dual+kv"])
def test_staggered_matches_jax_and_generate(setup, staggered, mode):
    prompts, knobs, je, te, jdone, tdone, _, _ = staggered[mode]
    for uid, p in enumerate(prompts):
        out = tdone[uid].output
        assert out == jdone[uid].output, (uid, out, jdone[uid].output)
        assert out == _generate(setup, p, 4, 32, **knobs), uid
        assert tdone[uid].status == "done" and len(out) == 4


@pytest.mark.parametrize("mode", ["dense", "dual+kv"])
def test_stats_match_jax(staggered, mode):
    *_, je, te, _, _, _, _ = staggered[mode]
    st = te.stats()
    assert set(st) == set(SHARED_STATS)
    assert st == _shared(je.stats())
    assert st["pages_free"] == st["pages_total"]
    _pool_equal(je, te)
    assert te.pool_stats() == {k: v for k, v in je.pool_stats().items()
                               if k in te.pool_stats()}
    health = te.health()
    assert health["stats"] == st and health["queue"] == []
    assert all(v is None for v in health["slots"].values())


@pytest.mark.parametrize("path", list(PATHS))
def test_page_recycling(setup, path):
    """A pool sized for two concurrent requests serves a third from
    recycled pages, with no eviction and the pool drained back to full."""
    serve = dict(slots=2, capacity=32, page_size=8, pages=8)
    prompts = [[1 + u, 2, 3] for u in range(3)]
    je, te, jdone, tdone, _, _ = _both(setup, serve, prompts, 6,
                                      **PATHS[path])
    assert _shared(je.stats()) == te.stats()
    _pool_equal(je, te)
    st = te.stats()
    assert st["evictions"] == 0
    assert st["pages_free"] == st["pages_total"] == 8
    for uid, p in enumerate(prompts):
        assert tdone[uid].output == jdone[uid].output
        assert tdone[uid].output == _generate(setup, p, 6, 32, **PATHS[path])


@pytest.mark.parametrize("path", list(PATHS))
def test_preemption_under_page_pressure(setup, path):
    """A pool too small for all admissions preempts (recompute) as the
    JAX engine does, and every request still gets its full budget."""
    serve = dict(slots=2, capacity=32, page_size=8, pages=5)
    prompts = [[1 + u, 2, 3] for u in range(3)]
    je, te, jdone, tdone, _, _ = _both(setup, serve, prompts, 20,
                                      **PATHS[path])
    assert te.evictions > 0
    assert te.evictions == je.evictions
    assert te.stats() == _shared(je.stats())
    _pool_equal(je, te)
    assert te.stats()["pages_free"] == 5
    for uid in range(3):
        assert len(tdone[uid].output) == 20 and tdone[uid].done
        assert tdone[uid].output == jdone[uid].output


@pytest.mark.parametrize("path", list(PATHS))
def test_sliding_window_reclaims_pages(setup, path):
    """With a 16-token window, pages whose block fell behind the window
    return to the pool: two requests that need 8 pages without reclaim
    run in 6, with no eviction, and the pool drains back to full."""
    serve = dict(slots=2, capacity=64, page_size=8, pages=6)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]]
    je, te = _engines(setup, serve, sliding_window=16, **PATHS[path])
    freed = []
    reclaim = te._reclaim_swa
    te._reclaim_swa = lambda: freed.append(reclaim()) or freed[-1]
    jdone, _ = _serve(je, jeng, prompts, 24, False)
    tdone, _ = _serve(te, teng, prompts, 24, False)
    assert sum(freed) >= 2
    assert te.evictions == je.evictions == 0
    assert te.stats() == _shared(je.stats())
    assert te.stats()["pages_free"] == te.stats()["pages_total"] == 6
    _pool_equal(je, te)
    for uid in range(2):
        assert len(tdone[uid].output) == 24
        assert tdone[uid].output == jdone[uid].output


def test_engine_admission_retire_and_refusals(setup):
    """The first token can finish a request at admission; max_new_tokens
    <= 0 retires with no compute; bad prompts are refused."""
    _, model = setup
    _, tcfg = _cfgs()
    first = _generate(setup, [5, 6, 7], 1, 32)[0]
    eng = teng.Engine(model, tcfg, slots=1, capacity=32, eos_id=first,
                      rc=TRunConfig(act_dtype="float32"), device="cpu")
    for uid, new in ((0, 8), (1, 1), (2, 0)):
        eng.submit(teng.Request(uid=uid, prompt=[5, 6, 7],
                                max_new_tokens=new))
    done = {r.uid: r for r in eng.run_to_completion()}
    assert done[0].output == done[1].output == [first]
    assert done[2].output == [] and done[2].done
    assert eng.decode_calls == 0
    for bad in ([], list(range(40))):
        with pytest.raises(ValueError):
            eng.submit(teng.Request(uid=9, prompt=bad, max_new_tokens=2))


def test_engine_refuses_enc_dec():
    whisper = tsmoke("whisper-base")
    from repro_torch.models import transformer as ttfm
    model = ttfm.init_model(whisper, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="decoder-only"):
        teng.Engine(model, whisper, device="cpu")


def test_engine_and_launcher_default_to_the_card(setup, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None rightly runs on it")
    _, model = setup
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.Engine(model, tcfg)
    argv = ["--arch", ARCH, "--smoke", "--requests", "2", "--max-new", "3"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(argv)
    tlaunch.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("req 0: [") and out[1].startswith("req 1: [")
    assert "tokens in" in out[-1]
