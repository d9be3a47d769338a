"""The sharded MoE on ``torch.distributed`` (gloo, four CPU ranks) against
the JAX package's local ``moe_forward`` on the same numpy weights.

One spawn of four ranks serves the whole file (``ranks``, module
scope): each rank runs :mod:`repro_torch.testing.sharded_moe`'s cases
(the shapes of ``tests/test_moe_sharded.py``, 4 experts for the expert-
parallel mesh) and writes its numbers, which the tests below hold case
by case.  The JAX side runs its local path only (no ``shard_map``), with
the identity the JAX package's own sharded test establishes: tokens are
replicated over the model axis before the dispatch, so each expert sees
tp identical capacity chunks and the mesh-total counted steps are tp ×
the local run's.

* EP, mesh (1, 4): dense, dual (K3's plain walk), weight and dual +
  kcondense (K4's) within 1e-4 of JAX's local dense output, executed ==
  counted, counted = 4 × JAX's local counted, dual < weight < dense;
* TP, 6 experts over (1, 4) at d_ff 32: the ``w_down`` k-plan warning
  fires once, the output within 1e-4;
* mesh (2, 2): each data shard dispatches its half of the batch, so the
  output is held against JAX's local output on each half and the aux
  loss against the mean of the halves';
* the launcher at world size 2 (mesh (2, 1)) serves the tokens of world
  size 1.

The ranks pick their port from the OS, run single-threaded and are
killed, with their output in the failure, if they outlast their timeout.
"""
import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import moe as jmoe
from repro.sparse import tape as jtape
from repro_torch.launch import serve
from repro_torch.testing import sharded_moe as sm

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
RANK_TIMEOUT = 240
TP = 4


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_moe")
    return d, sm.write_inputs(d / "inputs.npz")


@pytest.fixture(scope="module")
def ranks(inputs):
    d, _ = inputs
    sm.spawn([sys.executable, "-m", "repro_torch.testing.sharded_moe",
              "--inputs", str(d / "inputs.npz"), "--out", str(d),
              "--device", "cpu"], sm.WORLD, timeout=RANK_TIMEOUT, env=ENV,
             cwd=ROOT)
    return sm.load(d)


def _jax_taped(fn, *args):
    """``fn(*args)`` compiled, with its stats tape's entries returned as
    outputs of the compiled call."""
    names = []

    def traced(*a):
        with jtape.collect() as entries:
            out = fn(*a)
        names[:] = [e[0] for e in entries]
        return out, [e[1:] for e in entries]
    out, rest = jax.jit(traced)(*args)
    return out, [(name, *r) for name, r in zip(names, rest)]


@pytest.fixture(scope="module")
def jax_ref(inputs):
    """JAX's local moe_forward per (case, mode): y, aux and the moe.*
    counted steps (its XLA path, which counts what the kernels run);
    for the (2, 2) case also on each half of the batch."""
    _, arrs = inputs
    x = jnp.asarray(arrs["x"])
    out = {}
    for case, (e, f, _, modes) in sm.CASES.items():
        base = JModelConfig(**dataclasses.asdict(sm.config(e, f)))
        params = {k: jnp.asarray(arrs[f"{case}.{k}"])
                  for k in ("router", "w_up", "w_down")}
        for mode in modes:
            cfg = dataclasses.replace(
                base, **dict(sm.MODES[mode], sparse_use_kernel=False))
            xs = {"": x, "half0": x[:1], "half1": x[1:]} if case == "dp" \
                else {"": x}
            for part, xv in xs.items():
                (y, aux), ent = _jax_taped(
                    lambda p_, x_: jmoe.moe_forward(p_, x_, cfg), params, xv)
                counted = {e["name"]: e["sparse_steps"]
                           for e in jtape.summarize(ent)
                           if e["name"].startswith("moe.")}
                out[case, mode, part] = (np.asarray(y), float(aux), counted)
    return out


def _sharded(ranks, case, mode):
    """Every rank's (y, aux, tape) of a case; asserts they agree."""
    got = [(a[f"{case}.{mode}.y"], float(a[f"{case}.{mode}.aux"]),
            m[f"{case}.{mode}.tape"]) for a, m in ranks]
    for y, aux, tape in got[1:]:
        np.testing.assert_array_equal(y, got[0][0])
        assert aux == got[0][1] and tape == got[0][2]
    return got[0]


@pytest.mark.parametrize("mode", list(sm.CASES["ep"][3]))
def test_ep_matches_jax_local(ranks, jax_ref, mode):
    y, aux, tape = _sharded(ranks, "ep", mode)
    jy, jaux, _ = jax_ref["ep", "dense", ""]
    np.testing.assert_allclose(y, jy, atol=1e-4, rtol=0)
    assert abs(aux - jax_ref["ep", mode, ""][1]) <= 1e-6
    assert abs(aux - jaux) <= 1e-6
    if mode == "dense":
        assert tape == []


@pytest.mark.parametrize("mode", ["dual", "weight", "dual+kc"])
def test_ep_counts_are_tp_times_jax_local(ranks, jax_ref, mode):
    """Mesh-total counted steps = 4 × JAX's local counted, per projection;
    executed == counted (the kernels' walks ran the counted schedule)."""
    _, _, tape = _sharded(ranks, "ep", mode)
    local = jax_ref["ep", mode, ""][2]
    assert [e["name"] for e in tape] == ["moe.up", "moe.down"]
    for e in tape:
        assert e["executed_steps"] == e["sparse_steps"], e
        assert e["sparse_steps"] == TP * local[e["name"]], (e, local)
        assert e["sparse_steps"] < e["dense_steps"]


def test_ep_dual_skips_more_than_weight(ranks):
    """The activation bitmap survived the permute: dual schedules fewer
    steps than weight-only on the same operands, weight fewer than
    dense."""
    def total(mode, key="sparse_steps"):
        return sum(e[key] for e in _sharded(ranks, "ep", mode)[2])
    assert total("dual") < total("weight") < total("dual", "dense_steps")
    assert total("dual+kc") <= total("dual")


@pytest.mark.parametrize("mode", list(sm.CASES["tp"][3]))
def test_tp_matches_jax_local(ranks, jax_ref, mode):
    y, aux, tape = _sharded(ranks, "tp", mode)
    np.testing.assert_allclose(y, jax_ref["tp", "dense", ""][0], atol=1e-4,
                               rtol=0)
    assert abs(aux - jax_ref["tp", "dense", ""][1]) <= 1e-6
    for e in tape:
        assert e["executed_steps"] == e["sparse_steps"], e


def test_tp_warns_once_when_w_down_plan_cannot_be_sliced(ranks):
    for a, m in ranks:
        assert m["tp.down_ok"] is False and m["ep.down_ok"] is True
        first, second = m["tp.dual.warnings0"], m["tp.dual.warnings1"]
        assert len(first) == 1 and "w_down k-plan" in first[0], first
        assert second == []
        assert m["tp.dense.warnings0"] == []


@pytest.mark.parametrize("mode", list(sm.CASES["dp"][3]))
def test_dp_mesh_matches_jax_halves(ranks, jax_ref, mode):
    """Mesh (2, 2): each data shard dispatches its own half of the batch
    with the capacity of its own tokens."""
    y, aux, tape = _sharded(ranks, "dp", mode)
    halves = [jax_ref["dp", "dense", f"half{h}"] for h in range(2)]
    np.testing.assert_allclose(y, np.concatenate([h[0] for h in halves]),
                               atol=1e-4, rtol=0)
    assert abs(aux - (halves[0][1] + halves[1][1]) / 2) <= 1e-4
    # the whole batch at once dispatches otherwise (capacity 16, not 8)
    assert abs(aux - jax_ref["dp", "dense", ""][1]) > 1e-4
    if mode != "dense":
        local = [jax_ref["dp", mode, f"half{h}"][2] for h in range(2)]
        for e in tape:
            # every model rank runs its data half: 2 x each half's steps
            assert e["sparse_steps"] == 2 * sum(
                c[e["name"]] for c in local), (e, local)
            assert e["executed_steps"] == e["sparse_steps"]


@pytest.mark.parametrize("case,block", [("ep", [1, 32, 64]),
                                        ("tp", [6, 32, 8]),
                                        ("dp", [2, 16, 64])])
def test_ranks_hold_their_blocks(ranks, case, block):
    """EP holds E/4 experts; TP every expert's quarter of d_ff; (2, 2)
    E/2 experts cut along d over data."""
    for _, m in ranks:
        assert m[f"{case}.w_up_block"] == block


def test_blocks_round_trip_through_gather_slices(ranks):
    """``local_slice`` then ``gather_slices`` rebuilds the whole tensor on
    every rank, for every spec on both meshes, with the block shape the
    spec gives."""
    sizes = {(1, 4): {"data": 1, "model": 4}, (2, 2): {"data": 2,
                                                    "model": 2}}
    for _, m in ranks:
        assert len(m["blocks"]) == 2 * len(sm.BLOCK_SPECS)
        for shape, spec, block, ok in m["blocks"]:
            assert ok, (shape, spec)
            want = []
            for dim, e in zip((8, 4, 8), spec):
                n = 1
                for a in ([] if e is None else [e] if isinstance(e, str)
                          else e):
                    n *= sizes[tuple(shape)][a]
                want.append(dim // n)
            assert block == want, (shape, spec, block)


def test_port_local_matches_jax_local(ranks, jax_ref):
    """Each rank's whole module (no mesh) agrees with JAX's, so the
    sharded cases above compare like with like."""
    a, m = ranks[0]
    for case, (_, _, _, modes) in sm.CASES.items():
        for mode in modes:
            jy, jaux, counted = jax_ref[case, mode, ""]
            np.testing.assert_allclose(a[f"local.{case}.{mode}.y"], jy,
                                       atol=1e-4, rtol=0)
            got = {e["name"]: e["sparse_steps"]
                   for e in m[f"local.{case}.{mode}.tape"]}
            assert got == counted


# the element activities each case's rank keeps under kcondense: whole
# experts (EP) cut exactly; tensor parallel at d_ff 32 over 4 cuts w_up's
# columns inside a 16-wide block and drops w_down's k-plan, so none
ELEM_KEPT = {"ep": {"w_up@elem", "w_down@elem"}, "tp": set(),
             "dp": {"w_up@elem", "w_down@elem"}}


@pytest.mark.parametrize("case", list(sm.CASES))
def test_kcondense_plans_keep_element_activities(ranks, case):
    """A MoE sharded under kcondense keeps the element activities of its
    expert weights (as the single process caches them), each equal to
    that of the rank's weight block as it runs."""
    for _, m in ranks:
        assert set(m[f"{case}.elem"]) == ELEM_KEPT[case]
        assert all(m[f"{case}.elem"].values()), m[f"{case}.elem"]


def _tokens(out: str):
    return [line for line in out.splitlines() if line.startswith("req ")]


def test_launcher_world_2_serves_world_1s_tokens(capsys):
    """``launch/serve.py --smoke --device cpu`` on qwen3-moe at world size
    2 (host mesh (2, 1): the batch split over data, the MoE's TP branch at
    tp = 1) serves the tokens of one process with no group.  Its prompts
    are 3 tokens, so no expert drops a pick."""
    args = ["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu"]
    outs = sm.spawn([sys.executable, "-m", "repro_torch.launch.serve",
                     *args], 2, timeout=RANK_TIMEOUT, env=ENV, cwd=ROOT)
    assert "2 ranks over gloo" in outs[0]
    assert _tokens(outs[1]) == []            # only rank 0 prints
    torch.set_num_threads(1)
    serve.main(args)
    single = _tokens(capsys.readouterr().out)
    assert len(single) == 4
    assert _tokens(outs[0]) == single
