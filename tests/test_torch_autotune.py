"""The tuner, its cache and the resolution tiers against the JAX package's.

``sparse/autotune.py``, the Hopper-aware ``plan.knobs_valid``,
``launch/costmodel.py``'s step model, ``launch/roofline.sparse_matmul``
and ``sparse/site.resolve`` held against their JAX counterparts on the
CPU, where both packages run their CPU (interpret-mode) rules: keys,
buckets, validity over a lattice, scores and candidate lists (the JAX
module's roofline constants set to the port's by ``monkeypatch``), cache
files and their corruption, sweeps under one deterministic timer that
never calls the product (so no JAX interpret sweep runs), the three
resolution tiers, and ``nemotron-4-340b-smoke`` served on one tuned cache
by both packages: StepCounts bit-equal, tokens identical.

``tune_attn`` builds its synthetic operands from each package's own
random generator, so its rows are held against the knobs it must sweep,
not against JAX's timings; in float32, since the JAX package's bf16
attention sweep fails on the CPU (a bf16 × bf16 → f32 dot).
"""
import dataclasses
import itertools
import json
import os
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.configs.base import RunConfig as JRunConfig
from repro.launch import costmodel as jcost
from repro.launch import roofline as jroof
from repro.models import transformer as jtfm
from repro.serving import engine as jeng
from repro.serving import serve_loop as jserve
from repro.sparse import activation as jact
from repro.sparse import autotune as jatn
from repro.sparse import dispatch as jdsp
from repro.sparse import plan as jpln
from repro.sparse import site as jsite
from repro.sparse import tape as jtape
from repro.sparse import weights as jwts
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.kernels import bitmap_spgemm as bsk
from repro_torch.launch import costmodel as tcost
from repro_torch.launch import roofline as troof
from repro_torch.models import convert
from repro_torch.serving import engine as teng
from repro_torch.serving import serve_loop as tserve
from repro_torch.sparse import activation as tact
from repro_torch.sparse import autotune as tatn
from repro_torch.sparse import dispatch as tdsp
from repro_torch.sparse import plan as tpln
from repro_torch.sparse import site as tsite
from repro_torch.sparse import tape as ttape
from repro_torch.sparse import weights as twts
from repro_torch.testing import faults as tfaults

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "nemotron-4-340b"
DUAL_KV = dict(sparse_mode="dual", sparse_use_kernel=True, sparse_kv=True,
               sparse_block_t=8)


@pytest.fixture(autouse=True)
def _isolated():
    """Fresh caches, telemetry and warn-once sets in both packages."""
    jatn.reset()
    tatn.reset()
    jw, tw = set(jdsp._WARNED), set(tdsp._WARNED)
    yield
    jatn.reset()
    tatn.reset()
    jdsp._WARNED.clear()
    jdsp._WARNED.update(jw)
    tdsp._WARNED.clear()
    tdsp._WARNED.update(tw)


@pytest.fixture
def port_roofline(monkeypatch):
    """The JAX scorer on the port's card constants."""
    monkeypatch.setattr(jroof, "PEAK_FLOPS", troof.PEAK_FLOPS)
    monkeypatch.setattr(jroof, "HBM_BW", troof.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW", troof.LINK_BW)


def _knobs(kns):
    return [tuple(k) for k in kns]


# ---------------------------------------------------------------------------
# keys, buckets, validity, the step model and the scorer
# ---------------------------------------------------------------------------

KEY_CASES = [
    ("matmul", 1, 128, 512, "float32", None, ""),
    ("matmul", 64, 384, 96, "bfloat16", 0.5, ""),
    ("conv", 3000, 512, 240, "float32", 0.93, ""),
    ("grouped", 16, 128, 64, "float32", 0.3, "e4"),
    ("attn.score", 32, 2, 8, "float32", 0.5, "e8"),
    ("attn.value", 3, 16, 4096, "bfloat16", -1.0, "e32"),
]


@pytest.mark.parametrize("case", KEY_CASES, ids=[c[0] + str(c[1])
                                                  for c in KEY_CASES])
def test_make_key_and_buckets_match_jax(case):
    op, m, n, k, dt, sp, extra = case
    tkey = tatn.make_key(op, m, n, k, dtype=getattr(torch, dt), sparsity=sp,
                         platform="cpu", extra=extra)
    jkey = jatn.make_key(op, m, n, k, dtype=jnp.dtype(dt), sparsity=sp,
                         extra=extra)
    assert tkey == jkey
    assert tatn.make_key(op, m, n, k, dtype=dt, sparsity=sp,
                         platform="cuda", extra=extra) == \
        "cuda" + jkey[len("cpu"):]
    for x in (0, 1, 2, 3, 7, 8, 9, 1000, 4096, 4097):
        assert tatn.bucket_dim(x) == jatn.bucket_dim(x)
    for s in (None, -1.0, 0.0, 0.1, 0.2, 0.49, 0.62, 0.9, 0.95, 0.999, 1.5):
        assert tatn.bucket_sparsity(s) == jatn.bucket_sparsity(s)


def test_knobs_valid_lattice_matches_jax_interpret():
    """The CPU rules are the JAX package's interpret-mode rules, the VMEM
    panel budget included (K = 16384 exceeds it at the large blocks)."""
    shapes = [(1, 128, 512), (7, 96, 384), (64, 2048, 2048),
              (300, 12, 16384), (2, 8, 8)]
    n_rej = 0
    for (m, n, k), bm, bn, sk, (uk, cond), db in itertools.product(
            shapes, (0, 4, 8, 16, 64, 256, 512), (8, 12, 128, 256, 512),
            (8, 30, 32, 128, 256, 1024), ((False, None), (True, None),
                                          (True, "k")), (2, 4)):
        got = tpln.knobs_valid(m, n, k, bm, bn, sk, use_kernel=uk,
                               condense=cond, interpret=True,
                               dtype_bytes=db)
        want = jpln.knobs_valid(m, n, k, bm, bn, sk, use_kernel=uk,
                                condense=cond, interpret=True,
                                dtype_bytes=db)
        assert got == want, ((m, n, k), bm, bn, sk, uk, cond, db)
        n_rej += not got
    assert n_rej > 0
    assert tpln.kfused_panel_bytes(256, 512, 16384, 128, 4) == \
        jpln.kfused_panel_bytes(256, 512, 16384, 128, 4)
    assert tpln.slice_panel_bytes(64, 128, 32, 2) == \
        jpln.slice_panel_bytes(64, 128, 32, 2)


def test_card_rules_stage_what_the_kernels_stage():
    """The card's lane unit is 128, and a kernel backend is admitted only
    where every route's staged shared memory fits the budget."""
    assert tpln.knobs_valid(64, 2048, 2048, 64, 128, 32, use_kernel=True,
                            dtype_bytes=2)
    assert not tpln.knobs_valid(64, 2048, 2048, 64, 64, 32,
                                use_kernel=True, dtype_bytes=2)
    # csrc/spgemm_mma.cuh smem_bytes<BM>(): 4 stages of A, B and positions
    assert [bsk.stage_bytes("mma", bm, 0) for bm in (8, 32, 64, 256)] == \
        [79872, 89088, 55808, 144384]
    assert bsk.stage_bytes("narrow", 16, 192) == 16 * 224 * 2
    assert bsk.width_routes(2, 12, 192, True) == ("narrow",)
    assert bsk.width_routes(4, 128, 64, True) == ("simt", "mixed")
    assert bsk.width_routes(8, 128, 64, False) == ()
    assert not tpln.knobs_valid(8, 128, 64, 8, 128, 64, use_kernel=True,
                                dtype_bytes=8)
    assert max(bsk.stage_bytes(r, bm, 2048)
               for r in ("mma", "simt", "narrow", "mixed")
               for bm in (8, 16, 32, 64, 128, 256)) <= bsk.H100_SMEM_OPTIN


def test_step_model_and_sparse_roofline_match_jax(port_roofline):
    for bm, bn, sk, k, ad, wd, cond in itertools.product(
            (8, 128), (16, 256), (32, 128), (96, 4096), (0.0, 0.01, 0.3, 1.0),
            (0.5, 1.0), (None, "k")):
        assert tcost.sparse_step_fraction(
            bm, bn, sk, k, a_density=ad, w_density=wd, condense=cond) == \
            jcost.sparse_step_fraction(bm, bn, sk, k, a_density=ad,
                                       w_density=wd, condense=cond)
        assert tcost.predict_sparse_steps(
            37, 300, k, bm, bn, sk, a_density=ad, w_density=wd,
            condense=cond) == jcost.predict_sparse_steps(
            37, 300, k, bm, bn, sk, a_density=ad, w_density=wd,
            condense=cond)
    for backend in ("xla", "kernel", "kfused"):
        kw = dict(executed_fraction=0.37, block_m=16, block_n=256,
                  dtype_bytes=2, backend=backend, step_overhead_s=2e-4)
        assert troof.sparse_matmul(64, 4096, 1024, **kw) == \
            jroof.sparse_matmul(64, 4096, 1024, **kw)
    assert troof.roofline(1e12, 3e9, 1e8) == jroof.roofline(1e12, 3e9, 1e8)
    assert troof.model_flops(7e9, 128, "decode") == \
        jroof.model_flops(7e9, 128, "decode")


@pytest.mark.parametrize("shape", [(1, 128, 512), (64, 384, 96),
                                   (16, 128, 64), (300, 12, 16)])
def test_score_and_candidates_match_jax(port_roofline, shape):
    m, n, k = shape
    for sp_a, groups, db, mc in ((0.0, 1, 4, 8), (0.6, 4, 2, 3),
                                 (0.95, 1, 4, 1)):
        kw = dict(a_sparsity=sp_a, dtype_bytes=db, interpret=True,
                  n_groups=groups, max_candidates=mc)
        base = (jatn.Knobs("kernel", 128, 128, 128),)
        want = jatn.candidates(m, n, k, include=base, **kw)
        got = tatn.candidates(m, n, k, include=(tatn.Knobs(*base[0]),),
                              **kw)
        assert _knobs(got) == _knobs(want)
        for kn in want:
            assert tatn.score(tatn.Knobs(*kn), m, n, k, a_density=0.4,
                              dtype_bytes=db, interpret=True,
                              n_groups=groups) == \
                jatn.score(kn, m, n, k, a_density=0.4, dtype_bytes=db,
                           interpret=True, n_groups=groups)


# ---------------------------------------------------------------------------
# the cache file
# ---------------------------------------------------------------------------

def test_cache_roundtrip_and_foreign_version(tmp_path):
    path = str(tmp_path / "cache.json")
    k1 = tatn.record("matmul", 64, 128, 256, dtype=torch.float32,
                     sparsity=0.5, knobs=tatn.Knobs("xla", 8, 8, 8),
                     us=10.0, baseline_us=20.0, platform="cpu")
    k2 = tatn.record("grouped", 16, 32, 64, dtype=torch.float32,
                     sparsity=None, knobs=tatn.Knobs("kernel", 16, 16, 16),
                     us=5.0, extra="e4", platform="cpu")
    before = dict(tatn.get_cache().entries)
    assert tatn.save_cache(path) == path
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
    tatn.reset()
    assert tatn.get_cache().get(k1) is None
    tatn.load_cache(path)
    assert tatn.get_cache().entries == before
    # the same file reads back in the JAX package, entry for entry
    jatn.load_cache(path)
    assert jatn.get_cache().entries == before
    assert tuple(jatn.get_cache().get(k2)) == tuple(tatn.get_cache().get(k2))
    bad = tmp_path / "bad.json"
    bad.write_text('{"version": 999, "entries": {}}')
    for mod in (tatn, jatn):
        with pytest.raises(ValueError, match="version"):
            mod.TuningCache().load(str(bad))


@pytest.mark.parametrize("mode", ["truncate", "garbage", "binary"])
def test_corrupt_cache_degrades_as_jax(tmp_path, mode):
    """Every corruption mode degrades to an empty cache with one warning
    in both packages; the port's ``corrupt_json`` writes what the JAX
    package's does."""
    from repro.testing import faults as jfaults
    docs = []
    for tag, faults_mod in (("t", tfaults), ("j", jfaults)):
        path = tmp_path / f"{tag}.json"
        path.write_text(json.dumps({"version": 1, "entries": {
            "cpu|float32|matmul|m8|n8|k8|sany": {
                "backend": "xla", "block_m": 8, "block_n": 8,
                "slice_k": 8, "us": 1.0, "baseline_us": 2.0,
                "source": "tuned"}}}, indent=1))
        faults_mod.corrupt_json(str(path), mode)
        docs.append(path.read_bytes())
    assert docs[0] == docs[1]
    for mod, path in ((tatn, tmp_path / "t.json"), (jatn, tmp_path / "j.json")):
        with pytest.warns(RuntimeWarning, match="corrupt"):
            c = mod.TuningCache().load(str(path))
        assert c.entries == {}


def test_root_cache_loads_read_only_into_equal_knobs():
    """The repository root's cache (the JAX package's) loads in the port
    to the same Knobs, key for key, and is neither written nor touched;
    the port's default cache path lies under ``build/``."""
    path = ROOT / "BENCH_autotune_cache.json"
    stamp = path.stat().st_mtime_ns
    raw = path.read_bytes()
    tc = tatn.TuningCache().load(str(path))
    jc = jatn.TuningCache().load(str(path))
    assert tc.entries and set(tc.entries) == set(jc.entries)
    for key in tc.entries:
        assert tuple(tc.get(key)) == tuple(jc.get(key))
    assert path.stat().st_mtime_ns == stamp and path.read_bytes() == raw
    default = Path(tatn.default_cache_path(str(ROOT)))
    assert default.parent == ROOT / "build" / "repro_torch"
    assert default.name != path.name


# ---------------------------------------------------------------------------
# sweeps under one deterministic timer
# ---------------------------------------------------------------------------

def _fake_timer():
    """Times from a fixed sequence, never calling the product: both
    packages' sweeps, walking the same candidates in the same order, see
    the same times."""
    seq = itertools.count()
    return lambda fn: float(1000 - (next(seq) * 37) % 211)


def _operands(rng, m, k, n, e=None):
    lead = (e,) if e else ()
    x = rng.normal(size=lead + (m, k)).astype(np.float32)
    w = rng.normal(size=lead + (k, n)).astype(np.float32)
    w[..., :, : n // 2] = 0
    return x, w


def _strip(row):
    return {k: v for k, v in row.items() if k != "sweep"}, [
        {k: v for k, v in r.items()} for r in row["sweep"]]


@pytest.mark.parametrize("grouped", [False, True], ids=["matmul", "grouped"])
def test_tune_entries_match_jax(rng, grouped):
    if grouped:
        x, w = _operands(rng, 16, 64, 128, e=4)
        jx, jw = jact.relu(jnp.asarray(x), slice_k=16), jnp.asarray(w)
        tx, tw = tact.relu(torch.from_numpy(x), slice_k=16), \
            torch.from_numpy(w)
        jrow = jatn.tune_grouped(jx, jw, sparsity=0.5, interpret=True,
                                 timer=_fake_timer(), max_candidates=5)
        trow = tatn.tune_grouped(tx, tw, sparsity=0.5,
                                 timer=_fake_timer(), max_candidates=5)
    else:
        x, w = _operands(rng, 24, 96, 384)
        jx = jact.relu(jnp.asarray(x), slice_k=32)
        jw = jwts.plan_weight(jnp.asarray(w), slice_k=32)
        tx = tact.relu(torch.from_numpy(x), slice_k=32)
        tw = twts.plan_weight(torch.from_numpy(w), slice_k=32)
        jrow = jatn.tune_matmul(jx, jw, sparsity=0.3, w_sparsity=0.5,
                                interpret=True, timer=_fake_timer(),
                                max_candidates=6)
        trow = tatn.tune_matmul(tx, tw, sparsity=0.3, w_sparsity=0.5,
                                timer=_fake_timer(), max_candidates=6)
    assert _strip(trow) == _strip(jrow)
    assert tatn.get_cache().entries == jatn.get_cache().entries
    assert trow["tuned"]["us"] <= trow["baseline"]["us"]


def test_tune_attn_sweeps_the_block_t_lattice():
    """Both sites' baselines are the hand-set ``sparse_block_t`` tile,
    every block_t choice is timed, the winners land under the e-bucket
    keys, and the keys are the ones the JAX sweep writes."""
    cfg = dataclasses.replace(tsmoke(ARCH), sparse_mode="dual",
                              sparse_use_kernel=True, sparse_kv=True,
                              sparse_block_t=8)
    jcfg = dataclasses.replace(jsmoke(ARCH), sparse_mode="dual",
                               sparse_use_kernel=True, sparse_kv=True,
                               sparse_block_t=8)
    rows = tatn.tune_attn(cfg, batch=2, capacity=32, device="cpu",
                          timer=_fake_timer(), max_candidates=2,
                          dtype=torch.float32)
    jrows = jatn.tune_attn(jcfg, batch=2, capacity=32, interpret=True,
                           timer=_fake_timer(), max_candidates=2,
                           dtype=jnp.float32)
    assert [r["key"] for r in rows] == [r["key"] for r in jrows]
    score, value = rows
    assert score["baseline"]["block_m"] == 8
    assert value["baseline"]["slice_k"] == 8
    assert {r["block_m"] for r in score["sweep"]} >= {8, 16, 32}
    assert {r["slice_k"] for r in value["sweep"]} >= {8, 16, 32}
    for r, jr in zip(rows, jrows):
        assert [(s["backend"], s["block_m"], s["block_n"], s["slice_k"])
                for s in r["sweep"]] == \
            [(s["backend"], s["block_m"], s["block_n"], s["slice_k"])
             for s in jr["sweep"]]
        assert r["tuned"]["us"] <= r["baseline"]["us"]
        assert tatn.get_cache().get(r["key"]) is not None


def test_card_timer_is_the_default_on_the_card_only():
    assert tatn._timer_for(True, None) is tatn._default_timer
    assert tatn._timer_for(False, None) is tatn.card_timer

    def mine(fn):
        return 1.0
    assert tatn._timer_for(False, mine) is mine


# ---------------------------------------------------------------------------
# resolution tiers
# ---------------------------------------------------------------------------

def _norm(kw):
    out = dict(kw)
    if out.get("out_dtype") is not None:
        out["out_dtype"] = str(getattr(out["out_dtype"], "name",
                                       out["out_dtype"])).replace(
            "torch.", "")
    return out


SITES = [("matmul", "mlp.up", dict(m=24, n=384, k=96)),
         ("matmul", "mlp.down", dict(m=1, n=96, k=384)),
         ("grouped", "moe.up", dict(m=16, n=128, k=64, e=4)),
         ("conv", "conv.stem1", dict(m=3000, n=64, k=240)),
         ("attn.score", "attn.score", dict(m=32, n=3, k=16, e=4)),
         ("attn.value", "attn.value", dict(m=3, n=16, k=32, e=4))]


@pytest.mark.parametrize("tier", ["config", "cache", "costmodel", "dense"])
def test_site_resolve_tiers_match_jax(port_roofline, tier):
    base = dict(sparse_mode="dual", sparse_use_kernel=True,
                sparse_block_m=16, sparse_block_n=32, sparse_slice_k=16,
                sparse_block_t=8, sparse_tune_sparsity=0.5)
    if tier == "cache":
        base["sparse_autotune"] = True
    elif tier == "costmodel":
        base.update(sparse_autotune=True, sparse_costmodel=True)
    elif tier == "dense":
        base = dict(sparse_block_t=8)
    tcfg = dataclasses.replace(tsmoke(ARCH), **base)
    jcfg = dataclasses.replace(jsmoke(ARCH), **base)
    for i, (op, name, geo) in enumerate(SITES):
        pin = "float32" if op.startswith("attn") else ""
        if tier == "cache" and i % 2 == 0:
            # a served entry (every other site; the rest miss)
            e = geo.get("e", 1)
            extra = f"e{jatn.bucket_dim(e)}" if "e" in geo else ""
            kn = jatn.candidates(geo["m"], geo["n"], geo["k"],
                                 interpret=True, n_groups=e)[-1]
            jatn.record(op, geo["m"], geo["n"], geo["k"],
                        dtype=jnp.float32, sparsity=0.5, knobs=kn, us=1.0,
                        extra=extra)
            tatn.record(op, geo["m"], geo["n"], geo["k"],
                        dtype=torch.float32, sparsity=0.5,
                        knobs=tatn.Knobs(*kn), us=1.0, extra=extra,
                        platform="cpu")
        jst = jsite.make(op, name, out_dtype=pin)
        tst = tsite.make(op, name, out_dtype=pin)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jsite.resolve(jst, jcfg, dtype=jnp.float32,
                                 interpret=True, **geo)
            got = tsite.resolve(tst, tcfg, dtype=torch.float32,
                                device="cpu", **geo)
        assert _norm(got) == _norm(want), (tier, op)
    assert (tatn.HITS, tatn.MISSES) == (jatn.HITS, jatn.MISSES)
    assert set(tatn.OBSERVED) == set(jatn.OBSERVED)


# ---------------------------------------------------------------------------
# the engine's keys, and a generate on one tuned cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    p = jax.jit(lambda key: jtfm.init_model(key, jsmoke(ARCH))[0])(
        jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(lambda a: np.array(a), p)
    p["layers"]["pos0"]["mlp"]["w_up"][:, :, :128] = 0
    p["lm_head"][:, :128] = 0
    model = convert.from_jax_params(p, tsmoke(ARCH), device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, p), model


def _both_cfgs(**knobs):
    return (dataclasses.replace(jsmoke(ARCH), **knobs),
            dataclasses.replace(tsmoke(ARCH), **knobs))


def test_engine_autotune_keys_match_jax(setup, monkeypatch):
    jparams, model = setup
    # the JAX engine's discovery pass, its forwards compiled (the
    # lookups run while they trace, as they run eagerly)
    jitted = jax.jit(jtfm.forward, static_argnums=(2,),
                     static_argnames=("mode", "rc"))
    monkeypatch.setattr(jeng.tfm, "forward",
                        lambda p, b, c, **kw: jitted(p, b, c, **kw))
    jcfg, tcfg = _both_cfgs(**DUAL_KV)
    # the keys do not depend on the backend: JAX on its XLA path
    jcfg = dataclasses.replace(jcfg, sparse_use_kernel=False)
    je = jeng.Engine(jparams, jcfg, slots=1, capacity=16,
                     rc=JRunConfig(act_dtype="float32"))
    te = teng.Engine(model, tcfg, slots=1, capacity=16,
                     rc=TRunConfig(act_dtype="float32"), device="cpu")
    jkeys = je.autotune_keys(prompt_len=8, decode_steps=1)
    tkeys = te.autotune_keys(prompt_len=8, decode_steps=1)
    assert tkeys == jkeys
    assert any("|m1|" in k for k in tkeys) and any("|m8|" in k
                                                   for k in tkeys)
    assert any("|attn.score|" in k for k in tkeys)
    assert all(k in tatn.OBSERVED for k in tkeys)
    assert teng.Engine(model, tsmoke(ARCH), slots=1, capacity=16,
                       device="cpu").autotune_keys() == []


def _tuned_cache(path):
    """A cache serving every key a dual+kv smoke prefill and decode
    consult: per key the cost model's best non-dense candidate at its
    geometry, written by the port and read by both packages."""
    _, tcfg = _both_cfgs(**DUAL_KV)
    for obs in list(tatn.OBSERVED.values()):
        e = int(obs["extra"][1:]) if obs["extra"] else 1
        cands = tatn.candidates(obs["m"], obs["n"], obs["k"],
                                interpret=True, n_groups=e,
                                max_candidates=4)
        kn = next(c for c in cands if c.backend != "xla")
        tatn.record(obs["op"], obs["m"], obs["n"], obs["k"],
                    dtype=obs["dtype"], sparsity=obs["sparsity"],
                    knobs=kn, us=1.0, extra=obs["extra"], platform="cpu")
    tatn.save_cache(str(path))
    return dict(tatn.get_cache().entries)


def _jax_taped(fn, *args):
    """``fn(*args)`` (JAX) under ``jax.jit`` with its stats tape returned
    as outputs (the values an eager call records)."""
    names = []

    def traced(*a):
        with jtape.collect() as entries:
            out = fn(*a)
        names[:] = [e[0] for e in entries]
        return out, [e[1:] for e in entries]
    out, rest = jax.jit(traced)(*args)
    return out, [(name, *r) for name, r in zip(names, rest)]


def test_tuned_generate_matches_jax(setup, tmp_path):
    """One tuned cache loaded in both packages: the prefill's and a
    decode step's StepCounts bit-equal (the tuned geometry, not the
    config's), and ``generate``'s tokens identical."""
    jparams, model = setup
    jcfg0, tcfg0 = _both_cfgs(**DUAL_KV)
    te = teng.Engine(model, tcfg0, slots=1, capacity=16,
                     rc=TRunConfig(act_dtype="float32"), device="cpu")
    te.autotune_keys(prompt_len=8, decode_steps=1)
    entries = _tuned_cache(tmp_path / "tuned.json")
    tatn.reset()
    tatn.load_cache(str(tmp_path / "tuned.json"))
    jatn.load_cache(str(tmp_path / "tuned.json"))
    assert jatn.get_cache().entries == entries
    knobs = dict(DUAL_KV, sparse_autotune=True)
    jcfg, tcfg = _both_cfgs(**knobs)
    toks = np.ones((1, 8), np.int32)
    jrc = JRunConfig(act_dtype="float32", scan_unroll=True)
    trc = TRunConfig(act_dtype="float32")

    def jax_two_steps(p, b):
        from repro.models import transformer as jt
        caches = jt.init_caches(jcfg, 1, 16)
        out = jt.forward(p, b, jcfg, mode="prefill", caches=caches,
                         positions=jnp.arange(8, dtype=jnp.int32), rc=jrc)
        nxt = jnp.argmax(out.logits[:, -1], -1).astype(jnp.int32)
        out2 = jt.forward(p, {"tokens": nxt[:, None]}, jcfg, mode="decode",
                          caches=out.caches,
                          positions=jnp.asarray([8], jnp.int32), rc=jrc)
        return out.logits, out2.logits

    from repro_torch.models import transformer as ttfm
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (jl0, jl1), je = _jax_taped(jax_two_steps, jparams,
                                    {"tokens": jnp.asarray(toks)})
        hits0 = tatn.HITS
        with ttape.collect() as tent:
            caches = ttfm.init_caches(tcfg, 1, 16, device="cpu")
            out = model({"tokens": torch.from_numpy(toks).long()}, tcfg,
                        caches=caches, positions=torch.arange(8), rc=trc)
            nxt = out.logits[:, -1].argmax(-1)
            out2 = model({"tokens": nxt[:, None]}, tcfg, caches=out.caches,
                         positions=torch.tensor([8]), rc=trc)
        assert tatn.HITS > hits0 and tatn.STALE == 0
        jsum, tsum = jtape.summarize(je), ttape.summarize(tent)
        assert tsum == jsum
        np.testing.assert_allclose(out.logits.numpy(), np.asarray(jl0),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(out2.logits.numpy(), np.asarray(jl1),
                                   atol=1e-4, rtol=1e-4)
        # the tuned geometry changed the schedule's accounting
        with ttape.collect() as base_ent:
            model({"tokens": torch.from_numpy(toks).long()}, tcfg0,
                  caches=ttfm.init_caches(tcfg0, 1, 16, device="cpu"),
                  positions=torch.arange(8), rc=trc)
        assert ttape.summarize(base_ent) != tsum[:len(ttape.summarize(
            base_ent))]
        jt = jax.jit(lambda p, b: jserve.generate(
            p, b, jcfg, max_new_tokens=4, capacity=16,
            rc=JRunConfig(act_dtype="float32")))(
            jparams, {"tokens": jnp.asarray(toks)})
        tt = tserve.generate(model, {"tokens": torch.from_numpy(toks)},
                             tcfg, max_new_tokens=4, capacity=16, rc=trc,
                             device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_tuned_slice_k_reads_no_cached_plan_of_another(rng):
    """A cached attention plan (built at the config's slice_k) served a
    tuned slice_k is re-reduced from the weight, not read at the wrong
    granularity: the same schedule, steps and output as without the
    plan.  (The JAX package labels the cached plan with the tuned
    slice_k, which mismatches at full width.)"""
    cfg = dataclasses.replace(tsmoke(ARCH), sparse_mode="dual",
                              sparse_use_kernel=True, sparse_slice_k=16,
                              sparse_block_m=8, sparse_block_n=16,
                              sparse_autotune=True)
    x = torch.from_numpy(rng.normal(size=(1, 4, 96)).astype(np.float32))
    x[..., :40] = 0
    w = torch.from_numpy(rng.normal(size=(96, 2, 16)).astype(np.float32))
    w[40:70] = 0
    plan = tpln.slice_activity_rhs(w.reshape(96, -1), 16)
    st = tsite.make("matmul", "attn.q", axes=("embed", "heads"))
    tatn.record("matmul", 4, 32, 96, dtype=torch.float32, sparsity=None,
                knobs=tatn.Knobs("kernel", 8, 16, 32), us=1.0,
                platform="cpu")
    outs = []
    for pa in (plan, None):
        with ttape.collect() as ent:
            y, _ = tsite.project(x, w, st, cfg, plan_act=pa)
        outs.append((y, ttape.summarize(ent)))
    assert tatn.HITS == 2
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    assert outs[0][1] == outs[1][1]
    assert outs[0][1][0]["dense_steps"] == 1 * 2 * 3     # slice_k 32


def test_dispatch_autotune_consults_the_cache_as_jax(rng):
    """The in-dispatch consultation (``autotune=True``) of ``matmul``,
    ``grouped_matmul`` and ``conv2d`` (``op="conv"`` keys): on one cache
    both packages serve the same knobs, record the same steps and
    observe the same keys; ``kwargs_from_config`` carries it as JAX's."""
    from repro.sparse import conv as jconv
    from repro_torch.sparse import conv as tconv
    cfg = dataclasses.replace(tsmoke(ARCH), sparse_mode="dual",
                              sparse_autotune=True, sparse_tune_sparsity=0.5)
    jcfg = dataclasses.replace(jsmoke(ARCH), sparse_mode="dual",
                               sparse_autotune=True, sparse_tune_sparsity=0.5)
    assert tdsp.kwargs_from_config(cfg) == jdsp.kwargs_from_config(jcfg)
    x = rng.normal(size=(24, 96)).astype(np.float32)
    x[:, 40:] = 0
    w = rng.normal(size=(96, 64)).astype(np.float32)
    xg = rng.normal(size=(3, 16, 64)).astype(np.float32)
    wg = rng.normal(size=(3, 64, 32)).astype(np.float32)
    xc = np.maximum(rng.normal(size=(1, 6, 7, 4)), 0).astype(np.float32)
    wc = rng.normal(size=(3, 3, 4, 16)).astype(np.float32)
    for op, m, n, k, kn, extra in (
            ("matmul", 24, 64, 96, ("xla", 8, 32, 32), ""),
            ("grouped", 16, 32, 64, ("xla", 8, 16, 16), "e4"),
            ("conv", 20, 16, 36, ("xla", 16, 8, 16), "")):
        jatn.record(op, m, n, k, dtype=jnp.float32, sparsity=0.5,
                    knobs=jatn.Knobs(*kn), us=1.0, extra=extra)
        tatn.record(op, m, n, k, dtype=torch.float32, sparsity=0.5,
                    knobs=tatn.Knobs(*kn), us=1.0, extra=extra,
                    platform="cpu")
    kw = dict(mode="dual", block_m=128, block_n=128, slice_k=128,
              autotune=True, tune_sparsity=0.5, collect_stats=True)
    calls = (
        (lambda: jdsp.matmul(jnp.asarray(x), jnp.asarray(w),
                             interpret=True, **kw),
         lambda: tdsp.matmul(torch.from_numpy(x), torch.from_numpy(w),
                             **kw)),
        (lambda: jdsp.grouped_matmul(jnp.asarray(xg), jnp.asarray(wg),
                                     interpret=True, **kw),
         lambda: tdsp.grouped_matmul(torch.from_numpy(xg),
                                     torch.from_numpy(wg), **kw)),
        (lambda: jconv.conv2d(jnp.asarray(xc), jnp.asarray(wc), 1,
                              interpret=True, **kw),
         lambda: tconv.conv2d(torch.from_numpy(xc), torch.from_numpy(wc), 1,
                              **kw)))
    for jcall, tcall in calls:
        jy, js = jcall()
        ty, ts = tcall()
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                                   rtol=1e-4)
        assert [int(v) for v in ts] == [int(v) for v in js]
    assert (tatn.HITS, tatn.MISSES) == (jatn.HITS, jatn.MISSES) == (3, 0)
    assert set(tatn.OBSERVED) == set(jatn.OBSERVED)
    assert any("|conv|" in k for k in tatn.OBSERVED)
