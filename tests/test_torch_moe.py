"""MoE and SwiGLU parity: the port's ``models/moe.py``, SwiGLU ``MLP``,
stacked weight plans and the grouped on-the-fly entries against the JAX
package, on the same numpy inputs.

``moe_forward`` on both MoE smoke configs, float32, in dense, dual (K3)
and dual+kcondense (K4; the JAX side's Pallas kernels in interpret mode):
outputs within 1e-4, the auxiliary loss within 1e-6, the routing integers
(picks, destinations, kept picks) and the ``moe.*`` StepCounts equal bit
for bit.  The seeds' k-th/(k+1)-th gate gaps are asserted above 1e-4 so
that a near-tie fails with a message instead of flaking.  A decode-sized
input leaves experts empty (sparse < dense steps on both sides), and a
tight capacity factor drops picks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.kernels import grouped_spgemm as jgsk
from repro.models import mlp as jmlp
from repro.models import moe as jmoe
from repro.sparse import plan as jpln
from repro.sparse import tape as jtape
from repro.sparse import weights as jw
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.kernels import grouped_spgemm as tgsk
from repro_torch.models import mlp as tmlp
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.sparse import plan as tpln
from repro_torch.sparse import tape as ttape
from repro_torch.sparse import weights as tw

# the ops here are tiny: one thread keeps torch from crowding out the
# other test workers that share the cores
torch.set_num_threads(1)

ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b")
MODES = {
    "dense": dict(),
    "dual": dict(sparse_mode="dual", sparse_use_kernel=True),
    "dual+kc": dict(sparse_mode="dual", sparse_use_kernel=True,
                    sparse_kcondense=True),
}
# the smallest k-th/(k+1)-th gate gap the routing comparisons accept:
# the two packages' float32 gates differ by ~1e-7
GATE_GAP = 1e-4


def _moe_params(cfg, seed):
    """The JAX ``init_moe`` layouts and stddevs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)
    return {"router": normal((d, e), d ** -0.5),
            "w_up": normal((e, d, f), d ** -0.5),
            "w_down": normal((e, f, d), f ** -0.5),
            "w_gate": normal((e, d, f), d ** -0.5)}


def _port_moe(cfg, params):
    moe = tmoe.MoE(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for key, p in moe.named_parameters():
            p.copy_(torch.from_numpy(params[key]))
    return moe


def _x(shape, d, seed):
    return np.random.default_rng(seed).normal(size=(*shape, d)).astype(
        np.float32)


def _gate_gap(gates, k):
    """Smallest gap between consecutive gates among each token's top
    k + 1 (an order flip there changes ``top_i``)."""
    top = -np.sort(-np.asarray(gates), axis=-1)[:, :k + 1]
    return float(np.min(top[:, :-1] - top[:, 1:]))


def _both(cfg_name, mode, shape, seed=0, **over):
    jcfg = dataclasses.replace(jsmoke(cfg_name), **MODES[mode], **over)
    tcfg = dataclasses.replace(tsmoke(cfg_name), **MODES[mode], **over)
    params = _moe_params(jcfg, seed)
    x = _x(shape, jcfg.d_model, seed + 1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    with jtape.collect() as je:
        jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    moe = _port_moe(tcfg, params)
    with ttape.collect() as te:
        ty, taux = tmoe.moe_forward(moe, torch.from_numpy(x), tcfg)
    return (jcfg, tcfg, params, x, np.asarray(jy), ty.numpy(), float(jaux),
            float(taux), jtape.summarize(je), ttape.summarize(te))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", list(MODES))
def test_moe_forward_matches_jax(arch, mode):
    _, _, _, _, jy, ty, jaux, taux, jsum, tsum = _both(arch, mode, (2, 7))
    np.testing.assert_allclose(ty, jy, atol=1e-4, rtol=1e-4)
    assert abs(taux - jaux) <= 1e-6
    assert tsum == jsum
    if mode != "dense":
        assert [e["name"] for e in tsum] == ["moe.up", "moe.gate",
                                             "moe.down"]
        assert all(e["executed_steps"] == e["sparse_steps"] for e in tsum)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(2, 7), (4, 16), (2, 1)])
def test_routing_matches_jax_bit_for_bit(arch, shape):
    cfg = jsmoke(arch)
    params = _moe_params(cfg, 0)
    x = _x(shape, cfg.d_model, 1).reshape(-1, cfg.d_model)
    e, k = cfg.n_experts, cfg.n_experts_active
    cap = tmoe.capacity(tsmoke(arch), x.shape[0])
    jgates = jax.nn.softmax(jnp.dot(jnp.asarray(x),
                                    jnp.asarray(params["router"])), axis=-1)
    tgates = tmoe.router_gates(_port_moe(tsmoke(arch), params),
                               torch.from_numpy(x))
    np.testing.assert_allclose(tgates.numpy(), np.asarray(jgates),
                               atol=1e-6)
    gap = min(_gate_gap(jgates, k), _gate_gap(tgates, k))
    assert gap > GATE_GAP, (
        f"the seed's inputs put two gates within {gap:.1e}: a near-tie "
        "whose order may differ between the packages; pick another seed")
    jout = jmoe._dispatch_local(jnp.asarray(x), jgates, e, k, cap)
    tout = tmoe._dispatch_local(torch.from_numpy(x), tgates, e, k, cap)
    names = ("xe", "dest_e", "dest_p", "keep", "top_g", "top_i")
    for name, j, t in zip(names, jout, tout):
        if name in ("xe", "top_g"):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("mode", ["dual", "dual+kc"])
def test_decode_sized_input_skips_empty_experts(mode):
    """T = 2 tokens pick at most 4 of qwen3-moe-smoke's 8 experts: the
    empty experts' blocks are counts == 0 on both sides."""
    *_, jy, ty, jaux, taux, jsum, tsum = _both("qwen3-moe-235b-a22b", mode,
                                               (2, 1))
    np.testing.assert_allclose(ty, jy, atol=1e-4, rtol=1e-4)
    assert abs(taux - jaux) <= 1e-6
    assert tsum == jsum
    for entry in tsum:
        assert entry["executed_steps"] < entry["dense_steps"]
        assert entry["tiles_skipped"] > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_tight_capacity_drops_picks(mode):
    """capacity_factor 0.25 at 64 tokens: 8 slots an expert for ~32 picks,
    so most picks drop, the same ones on both sides."""
    jcfg, tcfg, params, x, jy, ty, jaux, taux, jsum, tsum = _both(
        "mixtral-8x7b", mode, (4, 16), capacity_factor=0.25)
    np.testing.assert_allclose(ty, jy, atol=1e-4, rtol=1e-4)
    assert abs(taux - jaux) <= 1e-6
    assert tsum == jsum
    xt = x.reshape(-1, jcfg.d_model)
    cap = tmoe.capacity(tcfg, xt.shape[0])
    assert cap == 8
    gates = tmoe.router_gates(_port_moe(tcfg, params), torch.from_numpy(xt))
    *_, keep, _, _ = tmoe._dispatch_local(torch.from_numpy(xt), gates,
                                          tcfg.n_experts,
                                          tcfg.n_experts_active, cap)
    assert 0 < int(keep.sum()) < keep.numel()
    dropped_rows = ~keep.any(-1).numpy()
    assert dropped_rows.any()                 # tokens with every pick dropped
    np.testing.assert_array_equal(ty.reshape(-1, tcfg.d_model)[dropped_rows],
                                  0)


def test_moe_plans_match_jax_and_serve_the_same():
    """``plan_layer_weights`` over stacked (E, K, N) expert weights, with
    ``@elem`` siblings, equals the JAX plans; forward on them equals
    forward without."""
    arch = "mixtral-8x7b"
    jcfg = dataclasses.replace(jsmoke(arch), **MODES["dual+kc"])
    tcfg = dataclasses.replace(tsmoke(arch), **MODES["dual+kc"])
    params = _moe_params(jcfg, 3)
    jplans = jw.plan_layer_weights({k: jnp.asarray(v)
                                    for k, v in params.items()},
                                   slice_k=jcfg.sparse_slice_k,
                                   block_n=jcfg.sparse_block_n)
    moe = _port_moe(tcfg, params)
    tplans = tw.plan_layer_weights(moe.weights(), slice_k=tcfg.sparse_slice_k,
                                   block_n=tcfg.sparse_block_n)
    assert sorted(tplans) == sorted(jplans) == sorted(
        ["w_up", "w_gate", "w_down", "w_up@elem", "w_gate@elem",
         "w_down@elem"])
    for key, j in jplans.items():
        np.testing.assert_array_equal(tplans[key].numpy(), np.asarray(j))
    x = torch.from_numpy(_x((2, 5), tcfg.d_model, 4))
    a, _ = tmoe.moe_forward(moe, x, tcfg, plans=tplans)
    b, _ = tmoe.moe_forward(moe, x, tcfg)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_stacked_activities_and_as_planned_match_jax():
    """The port's ``plan_layer_weights`` over stacked (..., K, N) weights
    equals the JAX ``stacked_slice_activity`` and ``stacked_element_activity``,
    and its ``plan_weight`` the JAX ``as_planned`` of a tensor."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(3, 4, 40, 24)).astype(np.float32)
    w[rng.random(w.shape) < 0.6] = 0
    w[:, :, 8:24] = 0
    jw_, tw_ = jnp.asarray(w), torch.from_numpy(w)
    tplans = tw.plan_layer_weights({"w_up": tw_}, slice_k=16, block_n=8)
    assert sorted(tplans) == ["w_up", "w_up@elem"]
    np.testing.assert_array_equal(
        tplans["w_up"].numpy(),
        np.asarray(jw.stacked_slice_activity(jw_, 16)))
    np.testing.assert_array_equal(
        tplans["w_up@elem"].numpy(),
        np.asarray(jw.stacked_element_activity(jw_, 8)))
    tp, jp = tw.plan_weight(tw_[0, 0], slice_k=16), jw.as_planned(jw_[0, 0],
                                                                   16)
    np.testing.assert_array_equal(tp.slice_act.numpy(),
                                  np.asarray(jp.slice_act))


@pytest.mark.parametrize("mode", ["dense", "dual"])
def test_swiglu_mlp_matches_jax(mode):
    """The port's MLP with SwiGLU against ``mlp_forward`` on a SwiGLU
    nemotron-smoke, with the ``w_gate`` plan key."""
    over = dict(MODES[mode], mlp_type="swiglu")
    jcfg = dataclasses.replace(jsmoke("nemotron-4-340b"), **over)
    tcfg = dataclasses.replace(tsmoke("nemotron-4-340b"), **over)
    rng = np.random.default_rng(6)
    d, f = jcfg.d_model, jcfg.d_ff
    params = {"w_up": rng.normal(size=(d, f)) * d ** -0.5,
              "w_down": rng.normal(size=(f, d)) * f ** -0.5,
              "w_gate": rng.normal(size=(d, f)) * d ** -0.5}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    params["w_gate"][:, :128] = 0           # dead gate block columns
    x = _x((2, 5), d, 7)
    mlp = tmlp.MLP(tcfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for key, p in mlp.weights().items():
            p.copy_(torch.from_numpy(params[key]))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jplans = (jw.plan_layer_weights(jp, slice_k=jcfg.sparse_slice_k)
              if mode != "dense" else None)
    tplans = (tw.plan_layer_weights(mlp.weights(),
                                    slice_k=tcfg.sparse_slice_k)
              if mode != "dense" else None)
    if tplans is not None:
        assert sorted(tplans) == ["w_down", "w_gate", "w_up"]
        for key in tplans:
            np.testing.assert_array_equal(tplans[key].numpy(),
                                          np.asarray(jplans[key]))
    with jtape.collect() as je:
        jy = jmlp.mlp_forward(jp, jnp.asarray(x), jcfg, plans=jplans)
    with ttape.collect() as te:
        ty = mlp(torch.from_numpy(x), tcfg, plans=tplans)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-4, rtol=1e-4)
    assert ttape.summarize(te) == jtape.summarize(je)
    if mode != "dense":
        assert [e["name"] for e in ttape.summarize(te)] == [
            "mlp.up", "mlp.gate", "mlp.down"]


def test_grouped_on_the_fly_entries_match_jax():
    """Ragged problems (one empty), odd C, K, N and a partial last slice:
    schedules equal, outputs within 1e-4 of the JAX entries (Pallas in
    interpret mode)."""
    e, c, k, n, bm, bn, sk = 5, 37, 200, 50, 16, 16, 32
    rng = np.random.default_rng(8)
    a = rng.normal(size=(e, c, k)).astype(np.float32)
    for i, frac in enumerate((1.0, 0.5, 0.0, 0.25, 0.9)[:e]):
        a[i, int(c * frac):] = 0
    b = rng.normal(size=(e, k, n)).astype(np.float32)
    b[rng.random(b.shape) < 0.5] = 0
    b[:, :sk] = 0                             # a dead k-slice everywhere
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    geom = tpln.clamp_geometry(c, n, k, bm, bn, sk)
    jks, jcounts = jgsk.plan_grouped(ja, jb, *geom)
    tks, tcounts = tgsk.plan_grouped(ta, tb, *geom)
    np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert (tcounts[2] == 0).all()
    kw = dict(block_m=bm, block_n=bn, slice_k=sk)
    for jfn, tfn in ((jgsk.grouped_spgemm, tgsk.grouped_spgemm),
                     (jgsk.grouped_spgemm_kfused,
                      tgsk.grouped_spgemm_kfused)):
        jy = jfn(ja, jb, interpret=True, **kw)
        ty = tfn(ta, tb, device="cpu", **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                                   rtol=1e-4)
        assert not ty[2].any()
    # the kfused entry's schedule, as its JAX counterpart plans it
    jkp = jpln.plan_grouped_kcondensed(
        jax.vmap(lambda x: jpln.element_activity_lhs(x, geom[0]))(ja),
        jax.vmap(lambda x: jpln.element_activity_rhs(x, geom[1]))(jb),
        geom[2])
    tkp = tpln.plan_grouped_kcondensed(tpln.element_activity_lhs(ta, geom[0]),
                                       tpln.element_activity_rhs(tb, geom[1]),
                                       geom[2])
    np.testing.assert_array_equal(tkp.gk.numpy(), np.asarray(jkp.gk))
    np.testing.assert_array_equal(tkp.counts.numpy(), np.asarray(jkp.counts))


@pytest.mark.parametrize("name", [*ARCHS, *(f"{a}-smoke" for a in ARCHS)])
def test_moe_configs_build_swiglu_moe_layers(name):
    from repro.configs import get_config as jget
    tcfg, jcfg = tget(name), jget(name)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), \
            field.name
    assert tcfg.period == jcfg.period == 1
    assert all(tcfg.layer_is_moe(p) for p in range(tcfg.period))
    small = dataclasses.replace(tcfg, n_layers=1, d_model=16, n_heads=2,
                                n_kv_heads=1, head_dim=8, d_ff=8,
                                vocab_size=32)
    model = ttfm.Transformer(small, device="meta")
    layer = model.layers[0]
    assert isinstance(layer.moe, tmoe.MoE) and not hasattr(layer, "mlp")
    assert tuple(layer.moe.w_gate.shape) == (tcfg.n_experts, 16, 8)


@pytest.mark.parametrize("name", ["nemotron-4-340b-smoke",
                                  "whisper-base-smoke"])
def test_dense_configs_build_no_moe_layers(name):
    """A family without experts keeps its MLP under the ``"mlp"`` key."""
    cfg = tget(name)
    assert not cfg.layer_is_moe(0) and cfg.period == 1
    model = ttfm.Transformer(cfg, device="meta")
    for layer in [*model.layers, *getattr(model, "enc_layers", [])]:
        assert layer.ffn_key == "mlp" and isinstance(layer.ffn, tmlp.MLP)
        assert not hasattr(layer, "moe")
