"""The sharded train step's smoke cases, one process per rank.

Every case starts from one set of float32 parameters, read from an
``.npz`` of ``<arch>/<parameter name>`` arrays (the JAX package's
``init_model`` through ``convert.from_jax_params`` in the tests,
:func:`write_port_inputs` on the card), and trains two steps of
``RunConfig(microbatches=2, learning_rate=1e-3, warmup_steps=2)`` on
``SyntheticTokens(vocab, 8, 16, seed=0)`` under the train rules, every
master, moment and gradient the rank's block:

* ``glm.4x1``/``glm.2x2``/``glm.1x4`` — chatglm3-6b-smoke, adamw, float32
  compute, on meshes (4, 1), (2, 2) and (1, 4); ``glm.bf16.2x2`` the same
  in bf16 compute (bf16 copies gathered whole);
* ``nemo.af.2x2`` — nemotron-4-340b-smoke, Adafactor (factored moments)
  on (2, 2); ``nemo.2x2`` the same with ``compress_grads``;
* ``mix.4x1``/``mix.1x4`` — mixtral-8x7b-smoke (4 experts, dense mode)
  on (4, 1) (the batch split four ways: each rank dispatches one row with
  its own capacity) and (1, 4) (expert parallel, the EP ``all_to_all``s
  carrying the gradient).

After its two steps ``glm.4x1`` saves a sharded checkpoint, trains a
third step, and the checkpoint is restored onto (2, 2) (``restore.2x2``)
and, by rank 0, into one process with no mesh (``restore.none``), each
checking that the whole arrays equal the saved ones bit for bit and
training the same third step.

Rank 0 writes each case's whole parameters and moments after its steps,
every rank its losses, ``grad_norm``\\ s, block shapes, bytes of masters and
moments, and whether its blocks are the slices of the whole parameters,
to ``rank<r>.npz``/``rank<r>.json`` in the output directory.
:func:`reference` runs a case's steps in one process (for a MoE on a
split batch, the mean of the gradients of each data block of each
microbatch, what the ranks compute).  :func:`spawn` (from
:mod:`repro_torch.testing.sharded_moe`) starts the ranks::

    python -m repro_torch.testing.sharded_train --inputs IN.npz \\
        --out DIR [--device cpu]      # one rank, under torchrun's variables
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.testing.sharded_moe import load, spawn  # noqa: F401

WORLD = 4
BATCH, SEQ, STEPS = 8, 16, 2
ARCHS = ("chatglm3-6b", "nemotron-4-340b", "mixtral-8x7b")
BASE_RC = dict(microbatches=2, learning_rate=1e-3, warmup_steps=2,
               act_dtype="float32")
# case → (arch, mesh shape, run config changes, compress_grads)
CASES = {
    "glm.4x1": ("chatglm3-6b", (4, 1), {}, False),
    "glm.2x2": ("chatglm3-6b", (2, 2), {}, False),
    "glm.1x4": ("chatglm3-6b", (1, 4), {}, False),
    "glm.bf16.2x2": ("chatglm3-6b", (2, 2), {"act_dtype": "bfloat16"},
                     False),
    "nemo.af.2x2": ("nemotron-4-340b", (2, 2), {"optimizer": "adafactor"},
                    False),
    "nemo.2x2": ("nemotron-4-340b", (2, 2), {"optimizer": "adafactor"}, True),
    "mix.4x1": ("mixtral-8x7b", (4, 1), {}, False),
    "mix.1x4": ("mixtral-8x7b", (1, 4), {}, False),
}
RESTORE = "glm.4x1"
RESTORE_MESH = (2, 2)


def run_config(case: str) -> RunConfig:
    return RunConfig(**{**BASE_RC, **CASES[case][2]})


def batches(cfg) -> list:
    """The numpy batches of steps 0 .. STEPS (the last one the restored
    step's)."""
    from repro_torch.data.pipeline import SyntheticTokens
    data = SyntheticTokens(cfg.vocab_size, BATCH, SEQ, seed=0)
    return [data.batch_at(i) for i in range(STEPS + 1)]


def write_port_inputs(path) -> None:
    """The port's own seed-0 parameters of every arch (float32, drawn on
    the CPU) to ``path``: the inputs where JAX is not at hand."""
    from repro_torch.models import model_zoo
    out = {}
    for arch in ARCHS:
        model = model_zoo.build_model(smoke_config(arch), 0, device="cpu")
        for n, p in model.named_parameters():
            out[f"{arch}/{n}"] = p.detach().numpy()
    np.savez(path, **out)


def load_model(inputs, arch: str, dev):
    """The float32 model of ``arch``'s smoke config holding the inputs'
    parameters, on ``dev``."""
    from repro_torch.models import transformer as tfm
    model = tfm.Transformer(smoke_config(arch), device=dev,
                            dtype=torch.float32)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(inputs[f"{arch}/{n}"])))
    return model


def _np(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy (later steps update the state in place)."""
    return t.detach().float().cpu().numpy().copy()


def _flat_state(prefix: str, params, ostate) -> Dict[str, np.ndarray]:
    out = {}
    for n, p in params.items():
        out[f"{prefix}.p.{n}"] = _np(p)
        out[f"{prefix}.m.{n}"] = _np(ostate.m[n])
        v = ostate.v[n]
        for key, t in (v.items() if isinstance(v, dict) else (("", v),)):
            out[f"{prefix}.v.{n}" + (f".{key}" if key else "")] = _np(t)
    return out


def _gather_tree(tree, shardings, mesh):
    """Every leaf of a sharded tree gathered whole on every rank."""
    from repro_torch.distributed import sharding as shd
    if isinstance(tree, dict):
        return {k: _gather_tree(v, shardings[k], mesh)
                for k, v in tree.items()}
    return shd.gather_slices(tree.detach().contiguous(), shardings, mesh)


def _whole_state(model, ostate, specs, mesh):
    """(whole parameters, whole optimizer state) of a sharded run, on
    every rank."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import state_pspecs, state_tree
    whole = _gather_tree(state_tree(model, ostate),
                         state_pspecs(specs, ostate), mesh)
    return whole["params"], opt.OptState(m=whole["m"], v=whole["v"],
                                         step=whole["step"])


def _torch_batch(b, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


class ShardedRun:
    """A case's model, specs, optimizer state and step on a mesh."""

    def __init__(self, case: str, inputs, mesh, dev):
        from repro_torch.distributed import sharding as shd
        from repro_torch.models import nn as tnn
        from repro_torch.training import optimizer as opt
        from repro_torch.training.train_loop import make_train_step
        self.case, self.mesh = case, mesh
        arch, _, _, compress = CASES[case]
        self.cfg, self.rc = smoke_config(arch), run_config(case)
        self.rules = shd.make_rules("train")
        whole = load_model(inputs, arch, dev)
        self.model = load_model(inputs, arch, dev)
        self.specs = shd.param_pspecs(self.model, self.cfg, self.rules, mesh)
        shd.shard_params_(self.model, self.specs, mesh, cfg=self.cfg,
                          rules=self.rules)
        wp = dict(whole.named_parameters())
        self.blocks_ok = all(
            torch.equal(p, shd.local_slice(wp[n], self.specs[n], mesh))
            for n, p in self.model.named_parameters())
        self.ostate = opt.init_opt_state(dict(self.model.named_parameters()),
                                         self.rc)
        self.ef = None
        if compress:
            from repro_torch.distributed.compression import \
                init_error_feedback
            self.ef = init_error_feedback(dict(self.model.named_parameters()))
        self.step_fn = make_train_step(self.cfg, self.rc,
                                       compress_grads=compress,
                                       param_pspecs=self.specs, mesh=mesh)
        self.axis_rules = lambda: tnn.axis_rules(self.rules, mesh=mesh)

    def step(self, batch, dev) -> Dict[str, float]:
        with self.axis_rules():
            _, self.ostate, self.ef, m = self.step_fn(
                self.model, self.ostate, self.ef, _torch_batch(batch, dev))
        return {k: float(v) for k, v in m.items()}

    def nbytes(self) -> int:
        """This rank's bytes of masters and moments."""
        n = sum(p.numel() * p.element_size()
                for p in self.model.parameters())
        for t in list(self.ostate.m.values()) + list(self.ostate.v.values()):
            for x in (t.values() if isinstance(t, dict) else (t,)):
                n += x.numel() * x.element_size()
        return n


def run_cases(inputs, out: Path, dev) -> tuple:
    """Every case on this rank (the group joined): ({name: array},
    {name: meta})."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshmod
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.fault_tolerance import CheckpointManager
    from repro_torch.training.train_loop import (load_state,
                                                 make_train_step,
                                                 state_tree)
    r = meshmod.rank()
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, object] = {}
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = meshmod.make_mesh(shape)
        return meshes[shape]

    for case, (arch, shape, _, _) in CASES.items():
        t0 = time.perf_counter()
        run = ShardedRun(case, inputs, mesh_of(shape), dev)
        data = batches(run.cfg)
        metrics = [run.step(data[i], dev) for i in range(STEPS)]
        meta[f"{case}.loss"] = [m["loss"] for m in metrics]
        meta[f"{case}.grad_norm"] = [m["grad_norm"] for m in metrics]
        meta[f"{case}.blocks_ok"] = run.blocks_ok
        meta[f"{case}.block_shapes"] = {
            n: list(p.shape) for n, p in run.model.named_parameters()}
        meta[f"{case}.specs"] = {n: [list(e) if isinstance(e, tuple) else e
                                     for e in s]
                                 for n, s in run.specs.items()}
        meta[f"{case}.bytes"] = run.nbytes()
        with run.axis_rules():
            params, ostate = _whole_state(run.model, run.ostate, run.specs,
                                          run.mesh)
        if r == 0:
            arrays.update(_flat_state(case, params, ostate))
        if case == RESTORE:
            d = out / "ckpt"
            mgr = CheckpointManager(str(d), keep=2)
            place = dict(shardings=_state_specs(run), mesh=run.mesh)
            mgr.save(STEPS, state_tree(run.model, run.ostate), **place)
            m = run.step(data[STEPS], dev)
            meta[f"{case}.loss3"] = m["loss"]
            with run.axis_rules():
                params, _ = _whole_state(run.model, run.ostate, run.specs,
                                         run.mesh)
            if r == 0:
                arrays.update({f"{case}.p3.{n}": _np(p)
                               for n, p in params.items()})
            mgr.wait()
            saved = _saved_arrays(d, STEPS)
            # onto another mesh
            rr = ShardedRun(case, inputs, mesh_of(RESTORE_MESH), dev)
            restored = mgr.restore_latest(
                state_tree(rr.model, rr.ostate), device=dev,
                shardings=_state_specs(rr), mesh=rr.mesh)
            rr.ostate = load_state(rr.model, restored[0])
            with rr.axis_rules():
                params, ostate = _whole_state(rr.model, rr.ostate, rr.specs,
                                              rr.mesh)
            meta["restore.2x2.bit_equal"] = _equal_saved(
                saved, params, ostate)
            m = rr.step(data[STEPS], dev)
            meta["restore.2x2.loss3"] = m["loss"]
            with rr.axis_rules():
                params, _ = _whole_state(rr.model, rr.ostate, rr.specs,
                                         rr.mesh)
            if r == 0:
                arrays.update({f"restore.2x2.p3.{n}": _np(p)
                               for n, p in params.items()})
                # into one process, no mesh
                from repro_torch.training import optimizer as opt
                one = load_model(inputs, arch, dev)
                ost = opt.init_opt_state(dict(one.named_parameters()),
                                         run.rc)
                tree, _ = ckpt.load(str(d / f"step_{STEPS:08d}"),
                                    state_tree(one, ost), device=dev)
                ost = load_state(one, tree)
                meta["restore.none.bit_equal"] = _equal_saved(
                    saved, dict(one.named_parameters()), ost)
                _, ost, _, m = make_train_step(run.cfg, run.rc)(
                    one, ost, None, _torch_batch(data[STEPS], dev))
                meta["restore.none.loss3"] = float(m["loss"])
                arrays.update({f"restore.none.p3.{n}": _np(p)
                               for n, p in one.named_parameters()})
            dist.barrier()
        meta[f"{case}.seconds"] = time.perf_counter() - t0
    return arrays, meta


def _state_specs(run: ShardedRun):
    from repro_torch.training.train_loop import state_pspecs
    return state_pspecs(run.specs, run.ostate)


def _saved_arrays(d: Path, step: int) -> Dict[str, np.ndarray]:
    path = d / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    out = {}
    for fname, keys in manifest["files"]:
        with np.load(path / fname) as z:
            for j, k in enumerate(keys):
                out[k] = z[f"a{j}"]
    return out


def _equal_saved(saved, params, ostate) -> bool:
    """Whether the whole state equals the saved arrays bit for bit."""
    from repro_torch.training.checkpoint import _encode, _flatten
    from repro_torch.training.train_loop import state_tree

    class _M:
        def named_parameters(self):
            return params.items()
    tree = state_tree(_M(), ostate)
    return all(np.array_equal(_encode(v)[0], saved[k])
               for k, v in _flatten(tree))


def reference(case: str, inputs, dev, steps: int = STEPS) -> dict:
    """The case's ``steps`` steps in one process from the same parameters:
    the one-device ``make_train_step``, or, for a MoE whose batch the mesh
    splits, the mean of the one-device gradients of each data block of
    each microbatch (each block dispatched with its own capacity, as the
    ranks dispatch), through the same ``ef_compress`` and
    ``apply_updates``.  Returns {"loss", "grad_norm", "params", "opt"}."""
    from repro_torch.distributed import compression as comp
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl
    arch, shape, _, compress = CASES[case]
    cfg, rc = smoke_config(arch), run_config(case)
    model = load_model(inputs, arch, dev)
    model.requires_grad_(True)
    ostate = opt.init_opt_state(dict(model.named_parameters()), rc)
    ef = (comp.init_error_feedback(dict(model.named_parameters()))
          if compress else None)
    dp = shape[0]
    blockwise = cfg.n_experts > 0 and dp > 1
    one = dataclasses.replace(rc, microbatches=1)
    grad_one = tl.make_grad_fn(cfg, one)
    losses, norms, step_grads = [], [], []
    for b in batches(cfg)[:steps]:
        tb = _torch_batch(b, dev)
        if not blockwise:
            step_grads.append(tl.make_grad_fn(cfg, rc)(model, tb)[0])
            _, ostate, ef, m = tl.make_train_step(
                cfg, rc, compress_grads=compress)(model, ostate, ef, tb)
        else:
            micro = tl.split_micro(tb, rc.microbatches)
            rows = BATCH // rc.microbatches // dp
            grads, loss = None, 0.0
            for i in range(rc.microbatches):
                for j in range(dp):
                    blk = {k: x[i, j * rows:(j + 1) * rows]
                           for k, x in micro.items()}
                    g, lo = grad_one(model, blk)
                    loss += float(lo)
                    grads = g if grads is None else {
                        n: grads[n] + g[n] for n in g}
            n_blk = rc.microbatches * dp
            grads = {n: g / n_blk for n, g in grads.items()}
            step_grads.append(grads)
            if compress:
                grads, ef = comp.ef_compress(grads, ef)
            _, ostate, m = opt.apply_updates(
                dict(model.named_parameters()), grads, ostate, rc,
                period=cfg.period)
            m = {"loss": loss / n_blk, **m}
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": norms, "grads": step_grads,
            "params": dict(model.named_parameters()), "opt": ostate,
            "lr": [float(opt.lr_schedule(s + 1, rc)) for s in range(steps)]}


def rtol(case: str) -> float:
    """The case's tolerance: 1e-4 relative in float32 compute, 2e-2 in
    bf16."""
    return 2e-2 if run_config(case).act_dtype == "bfloat16" else 1e-4


def compare(case: str, ranks: list, ref: dict) -> dict:
    """Hold the ranks' run of ``case`` (:func:`load`) to its one-process
    :func:`reference`: every rank's losses and ``grad_norm`` within
    :func:`rtol`, rank 0's whole parameters within it x the tensor's
    largest value, except where a step's gradient lies under it x the
    largest gradient (Adam moves those by ±lr: within 2 x the lrs' sum),
    and with ``compress_grads`` at most 1 in 1000 of the model's elements
    past that (a code an ulp from a rounding boundary).  Raises
    ``AssertionError``; returns {"loss_err", "param_err", "off"}."""
    tol = rtol(case)
    loss_err = 0.0
    for r, (_, meta) in enumerate(ranks):
        for key in ("loss", "grad_norm"):
            for got, want in zip(meta[f"{case}.{key}"], ref[key]):
                err = abs(got - want) / abs(want)
                loss_err = max(loss_err, err)
                if not err <= tol:
                    raise AssertionError(f"{case} rank {r} {key}: {got} "
                                         f"against {want}")
    arrays = ranks[0][0]
    gmax = max(float(g.abs().max()) for gs in ref["grads"]
               for g in gs.values())
    off = total = 0
    param_err = 0.0
    for n, p in ref["params"].items():
        want = p.detach().float().cpu().numpy()
        diff = np.abs(arrays[f"{case}.p.{n}"] - want)
        small = np.zeros(want.shape, bool)
        for gs in ref["grads"]:
            small |= gs[n].abs().float().cpu().numpy() <= tol * gmax
        scale = max(float(np.abs(want).max()), 1e-30)
        bad = diff > np.where(small, 2 * sum(ref["lr"]), tol * scale)
        if diff.max() > 2 * sum(ref["lr"]) or (bad.any()
                                               and not CASES[case][3]):
            raise AssertionError(f"{case} {n}: {bad.sum()} elements off, "
                                 f"largest {diff.max()}")
        param_err = max(param_err, float(diff[~small].max(initial=0))
                        / scale)
        off += int(bad.sum())
        total += bad.size
    if off > 1e-3 * total:
        raise AssertionError(f"{case}: {off} of {total} elements off")
    return dict(loss_err=loss_err, param_err=param_err, off=off)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda)")
    args = ap.parse_args(argv)
    from repro_torch.launch import mesh as meshmod
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = meshmod.init_distributed(args.device)
    r = meshmod.rank()
    out = Path(args.out)
    arrays, meta = run_cases(np.load(args.inputs), out, dev)
    meta["backend"] = torch.distributed.get_backend()
    np.savez(out / f"rank{r}.npz", **arrays)
    (out / f"rank{r}.json").write_text(json.dumps(meta))
    meshmod.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
