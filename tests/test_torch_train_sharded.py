"""The sharded train step on ``torch.distributed`` (gloo, four CPU ranks)
against the JAX package's one-device train step on the same numpy
parameters.

One spawn of four ranks serves the whole file (``ranks``, module scope):
each rank runs :mod:`repro_torch.testing.sharded_train`'s cases (two
steps each, every master, moment and gradient the rank's block under the
train rules) from the JAX package's ``init_model`` parameters
(``convert.from_jax_params``), and writes its numbers.  The JAX side runs
on one device, with no ``shard_map`` and no forced host devices, while
the ranks run: ``make_train_step`` itself for chatglm3-6b-smoke in
float32, and for the other cases the same step from ``jax.grad`` of
``lm_loss`` on each microbatch, ``ef_compress`` and ``apply_updates``.
For a MoE on a split data axis it is the mean of the gradients of each
data block of each microbatch: each data shard dispatches its own rows
with its own capacity (the identity ``test_dp_mesh_matches_jax_halves``
rests on).

* losses and ``grad_norm`` of both steps within 1e-4 relative in float32
  compute, 2e-2 in bf16;
* parameters within 1e-4 (2e-2 in bf16) x the tensor's largest value,
  except where a step's gradient lies under that tolerance x the largest
  gradient (Adam moves those by ±lr, so they may differ by 2 x the lrs'
  sum); with ``compress_grads`` at most 1 in 1000 of the model's
  elements past that (none past 2 x the lrs' sum): an int8 code an ulp
  of the gradient from a rounding boundary can round the other way;
* Adafactor's factored moments (``row``/``col``) on (2, 2), without
  compression (one code rounded the other way moves its whole row and
  column of the factored moment);
* each rank holds exactly its blocks: the slices of the whole parameters,
  tiling them, with the bytes of masters and moments they imply;
* elastic restore: saved on (4, 1) and loaded on (2, 2) and with no
  mesh, the whole arrays bit-equal to the saved ones and the continued
  step within tolerance of the uninterrupted run;
* the launcher at world size 2 prints the losses of world size 1.
"""
import functools
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as jconfigs
from repro.configs.base import RunConfig as JRunConfig
from repro.distributed import compression as jcomp
from repro.models import transformer as jtfm
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.configs import smoke_config
from repro_torch.models import convert
from repro_torch.training import optimizer as topt
from repro_torch.testing import sharded_train as st

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
RANK_TIMEOUT = 240
# the case that runs JAX's make_train_step itself
LITERAL = "glm.4x1"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    p, _ = jtfm.init_model(jax.random.PRNGKey(0), jconfigs.smoke_config(arch))
    return _np(p)


def _leaf(tree, name, period):
    """The JAX tree's value for port parameter ``name`` (a stacked 1-D
    leaf's factored ``col`` is shared by its layers)."""
    key, j = topt.stacked_leaf(name, period)
    for part in key.split("."):
        tree = tree[part]
    if isinstance(tree, dict):
        return {k: (v if j is None or (k == "col" and v.ndim == 1)
                    else v[j]) for k, v in tree.items()}
    return tree if j is None else tree[j]


class _Spawn:
    """The ranks, started at once and joined on first use."""

    def __init__(self, cmd, world, out):
        self.out, self.box = out, {}

        def run():
            try:
                self.box["outs"] = st.spawn(cmd, world, timeout=RANK_TIMEOUT,
                                            env=ENV, cwd=ROOT)
            except Exception as e:       # re-raised by get()
                self.box["error"] = e
        self.thread = threading.Thread(target=run)
        self.thread.start()

    def get(self):
        self.thread.join()
        if "error" in self.box:
            raise self.box["error"]
        return self.box["outs"]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_train")
    arrays = {}
    for arch in st.ARCHS:
        model = convert.from_jax_params(_jax_params(arch),
                                        smoke_config(arch), device="cpu")
        for n, p in model.named_parameters():
            arrays[f"{arch}/{n}"] = p.detach().numpy()
    np.savez(d / "inputs.npz", **arrays)
    run = _Spawn([sys.executable, "-m", "repro_torch.testing.sharded_train",
                  "--inputs", str(d / "inputs.npz"), "--out", str(d),
                  "--device", "cpu"], st.WORLD, d)
    yield run
    run.thread.join()


@pytest.fixture(scope="module")
def ranks(spawned, jax_ref):
    spawned.get()
    return st.load(spawned.out)


def _cast(p):
    return jax.tree_util.tree_map(
        lambda w: w.astype(jnp.bfloat16)
        if w.dtype == jnp.float32 and w.ndim >= 2 else w, p)


def _jax_case(case):
    """The case's steps on one device: {"loss", "grad_norm", "params",
    "opt", "grads"} (the gradients of each step, for the tolerance
    mask)."""
    arch, shape, changes, compress = st.CASES[case]
    jcfg = jconfigs.smoke_config(arch)
    jrc = JRunConfig(**{**st.BASE_RC, **changes})
    cast = _cast if jrc.act_dtype == "bfloat16" else (lambda p: p)
    k, dp = jrc.microbatches, shape[0]
    parts = dp if jcfg.n_experts and dp > 1 else 1

    @jax.jit
    def grad_of(p, mb):
        (_, m), g = jax.value_and_grad(
            lambda p: jtfm.lm_loss(cast(p), mb, jcfg, rc=jrc),
            has_aux=True)(p)
        return g, m["loss"]

    apply = jax.jit(functools.partial(jopt.apply_updates, rc=jrc))
    step = (jax.jit(jtl.make_train_step(jcfg, jrc, compress_grads=compress))
            if case == LITERAL else None)
    p = jax.tree_util.tree_map(jnp.asarray, _jax_params(arch))
    ostate = jopt.init_opt_state(p, jrc)
    ef = jcomp.init_error_feedback(p) if compress else None
    out = {"loss": [], "grad_norm": [], "grads": []}
    for b in st.batches(smoke_config(arch))[:st.STEPS]:
        micro = jtl._split_micro(b, k)
        rows = st.BATCH // k // parts
        gs, losses = [], []
        for i in range(k):
            for j in range(parts):
                g, loss = grad_of(p, {key: x[i, j * rows:(j + 1) * rows]
                                      for key, x in micro.items()})
                gs.append(g)
                losses.append(float(loss))
        g = jax.tree_util.tree_map(lambda *x: sum(x) / len(x), *gs)
        out["grads"].append(_np(g))
        if step is not None:
            p, ostate, ef, m = step(p, ostate, ef, b)
        else:
            if compress:
                g, ef = jcomp.ef_compress(g, ef)
            p, ostate, m = apply(p, g, ostate)
            m = {"loss": np.mean(losses), **m}
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"], out["opt"] = _np(p), _np(ostate)
    out["lr"] = [float(jopt.lr_schedule(s, jrc)) for s in (1, 2)]
    return out


@pytest.fixture(scope="module")
def jax_ref(spawned):
    """Every case's JAX steps, computed while the ranks run (the cases on
    one arch and compute type share one run)."""
    out, seen = {}, {}
    for case, (arch, shape, changes, compress) in st.CASES.items():
        moe_split = smoke_config(arch).n_experts and shape[0] > 1
        key = (arch, tuple(sorted(changes.items())), compress,
               shape[0] if moe_split else 1)
        if key not in seen:
            seen[key] = _jax_case(case)
        out[case] = seen[key]
    return out


def _rtol(case):
    return 2e-2 if st.CASES[case][2].get("act_dtype") == "bfloat16" else 1e-4


@pytest.mark.parametrize("case", list(st.CASES))
def test_losses_match_jax(ranks, jax_ref, case):
    want, rtol = jax_ref[case], _rtol(case)
    for r, (_, meta) in enumerate(ranks):
        np.testing.assert_allclose(meta[f"{case}.loss"], want["loss"],
                                   rtol=rtol, err_msg=f"rank {r}")
        np.testing.assert_allclose(meta[f"{case}.grad_norm"],
                                   want["grad_norm"], rtol=rtol,
                                   err_msg=f"rank {r}")


def _params_close(got_of, want, case, prefix):
    """Every parameter of the case within tolerance (module docstring)."""
    cfg = smoke_config(st.CASES[case][0])
    compress = st.CASES[case][3]
    rtol = _rtol(case)
    names = [n for n, _ in _meta_model(cfg).named_parameters()]
    gmax = max(np.abs(_leaf(g, n, cfg.period)).max()
               for g in want["grads"] for n in names)
    n_bad = total = 0
    for n in names:
        got = got_of(f"{prefix}.p.{n}")
        ref = np.asarray(_leaf(want["params"], n, cfg.period), np.float32)
        small = np.zeros(ref.shape, bool)
        for g in want["grads"]:
            small |= np.abs(_leaf(g, n, cfg.period)) <= rtol * gmax
        atol = np.where(small, 2 * sum(want["lr"]),
                        rtol * np.abs(ref).max())
        bad = np.abs(got - ref) > atol
        assert compress or not bad.any(), (
            f"{case} {n}: {bad.sum()} of {bad.size} elements off, largest "
            f"{np.abs(got - ref).max()} (atol {rtol * np.abs(ref).max()})")
        assert np.abs(got - ref).max() <= 2 * sum(want["lr"]), (case, n)
        n_bad += bad.sum()
        total += bad.size
    assert n_bad <= 1e-3 * total, (case, n_bad, total)


@functools.lru_cache(maxsize=None)
def _meta_model(cfg):
    from repro_torch.models import model_zoo
    return model_zoo.abstract_params(cfg)[0]


@pytest.mark.parametrize("case", list(st.CASES))
def test_params_match_jax(ranks, jax_ref, case):
    arrays = ranks[0][0]
    _params_close(lambda k: arrays[k], jax_ref[case], case, case)


def test_adafactor_factored_moments_match_jax(ranks, jax_ref):
    """nemo.af.2x2: every factored second moment's row and col (float32)
    and the unfactored ones (the final norm's) within 1e-4 x the largest
    value of JAX's."""
    case = "nemo.af.2x2"
    cfg = smoke_config(st.CASES[case][0])
    arrays, want = ranks[0][0], jax_ref[case]["opt"]
    seen = 0
    for n, _ in _meta_model(cfg).named_parameters():
        ref = _leaf(want.v, n, cfg.period)
        parts = ref.items() if isinstance(ref, dict) else (("", ref),)
        for key, r in parts:
            got = arrays[f"{case}.v.{n}" + (f".{key}" if key else "")]
            r = np.asarray(r, np.float32)
            np.testing.assert_allclose(got, r, rtol=0,
                                       atol=1e-4 * np.abs(r).max(),
                                       err_msg=f"{n} {key}")
            seen += key in ("row", "col")
    assert seen > 0


@pytest.mark.parametrize("case", list(st.CASES))
def test_ranks_hold_their_blocks(ranks, case):
    """Each rank's masters are the slices of the whole parameters under
    its specs, the blocks tile each parameter, and a rank's bytes of
    masters and moments are what its blocks imply."""
    arch = st.CASES[case][0]
    cfg, rc = smoke_config(arch), st.run_config(case)
    whole = {n: tuple(p.shape)
             for n, p in _meta_model(cfg).named_parameters()}
    sizes = dict(zip(("data", "model"), st.CASES[case][1]))
    for r, (_, meta) in enumerate(ranks):
        assert meta[f"{case}.blocks_ok"], r
        nbytes = 0
        for n, shape in whole.items():
            block = tuple(meta[f"{case}.block_shapes"][n])
            spec = meta[f"{case}.specs"][n]
            want = list(shape)
            for d, e in enumerate(spec):
                for a in ([e] if isinstance(e, str) else e or []):
                    want[d] //= sizes[a]
            assert block == tuple(want), (r, n, block, spec)
            numel = int(np.prod(block))
            nbytes += 4 * numel                                  # master
            if rc.optimizer == "adafactor":
                nbytes += 2 * numel                              # bf16 m
                if topt.jax_ndim(n, np.empty(shape)) < 2:
                    nbytes += 4 * numel
                elif len(block) == 1:
                    nbytes += 4 + 4 * block[0]                   # row, col
                else:
                    nbytes += 4 * (int(np.prod(block[:-1]))
                                   + int(np.prod(block[:-2] + block[-1:])))
            else:
                nbytes += 8 * numel                              # m, v
        assert meta[f"{case}.bytes"] == nbytes, r
    total = sum(int(np.prod(s)) for s in whole.values())
    held = sum(sum(int(np.prod(b)) for b in
                   meta[f"{case}.block_shapes"].values())
               for _, meta in ranks)
    assert total <= held <= st.WORLD * total


def test_elastic_restore(ranks):
    """Saved on (4, 1) after two steps, restored onto (2, 2) and into one
    process: the whole arrays equal the saved ones bit for bit, and the
    third step lands within 1e-5 of the uninterrupted run's."""
    arrays, meta = ranks[0]
    assert meta["restore.2x2.bit_equal"] and meta["restore.none.bit_equal"]
    assert all(m["restore.2x2.bit_equal"] for _, m in ranks)
    case = st.RESTORE
    loss3 = meta[f"{case}.loss3"]
    for tag in ("restore.2x2", "restore.none"):
        assert meta[f"{tag}.loss3"] == pytest.approx(loss3, rel=1e-5), tag
        for key in arrays:
            if key.startswith(f"{case}.p3."):
                n = key[len(f"{case}.p3."):]
                np.testing.assert_allclose(arrays[f"{tag}.p3.{n}"],
                                           arrays[key], rtol=0, atol=1e-5,
                                           err_msg=f"{tag} {n}")


def test_launcher_world_2_trains_as_world_1(tmp_path):
    """``launch/train.py --smoke --device cpu`` on chatglm3-6b at world
    size 2 (the host mesh (2, 1): each rank two of the four rows of a
    microbatch) prints the losses of one process with no group."""
    def cmd(d):
        return [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                "chatglm3-6b", "--smoke", "--steps", "11", "--global-batch",
                "8", "--seq", "16", "--ckpt-every", "100", "--ckpt-dir",
                str(tmp_path / d), "--device", "cpu"]
    alone = subprocess.Popen(cmd("one"), env=dict(ENV, OMP_NUM_THREADS="1"),
                             cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        outs = st.spawn(cmd("two"), 2, timeout=RANK_TIMEOUT, env=ENV,
                        cwd=ROOT)
        one = alone.communicate(timeout=RANK_TIMEOUT)[0]
    finally:
        if alone.poll() is None:
            alone.kill()
            alone.communicate()
    assert alone.returncode == 0
    steps = [line for line in one.splitlines() if line.startswith("step ")]
    assert len(steps) == 2 and one.rstrip().endswith("training complete")
    assert "torch.distributed: 2 ranks over gloo" in outs[0]
    assert [line for line in outs[0].splitlines()
            if line.startswith("step ")] == steps
    assert not [line for line in outs[1].splitlines()
                if line.startswith("step ")]
