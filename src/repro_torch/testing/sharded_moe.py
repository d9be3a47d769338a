"""The sharded MoE's smoke cases, one process per rank.

The shapes of the JAX package's own sharded-MoE test: d_model 32, relu
experts, top-1, capacity factor 2, blocks of 8 × 16, slice_k 16, float32,
x of (2, 16, 32), every expert's ``w_up``/``w_down`` block-pruned by
half.  :func:`write_inputs` draws the weights and the input with numpy
from a seed; each rank reads them, builds the same MoEs, cuts them to
its mesh (:func:`repro_torch.models.moe.shard_moe_`, with the element
activities that kcondense caches) and runs:

* ``ep`` — 4 experts over a (1, 4) mesh (expert parallel) in dense,
  dual, weight and dual + kcondense, on the cached plans;
* ``tp`` — 6 experts over (1, 4) (tensor parallel) at d_ff 32, whose
  ``w_down`` k-plan cannot be sliced over 4 (8-deep local k under
  slice_k 16), in dense and in dual on cached plans, twice (the warning
  fires once);
* ``dp`` — 4 experts over (2, 2): the batch split over data, experts
  over model, in dense and dual;

and beside each the same module whole, with no mesh (``local_*``); then
an (8, 4, 8) tensor's blocks under a few specs through
``sharding.local_slice`` and back through ``gather_slices``.  Each
rank writes ``rank<r>.npz`` (outputs and aux losses) and ``rank<r>.json``
(the ``moe.*`` tape entries, the warnings, which cached element
activities equal those of the rank's weight blocks) into the output
directory.  :func:`spawn` starts the ranks as
subprocesses with the ``torchrun`` variables set and fails with their
output when one fails or the time runs out::

    python -m repro_torch.testing.sharded_moe --inputs IN.npz --out DIR \\
        [--device cpu]      # one rank, under torchrun's variables
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

WORLD = 4
MODES = {
    "dense": dict(),
    "dual": dict(sparse_mode="dual", sparse_use_kernel=True),
    "weight": dict(sparse_mode="weight", sparse_use_kernel=True),
    "dual+kc": dict(sparse_mode="dual", sparse_use_kernel=True,
                    sparse_kcondense=True),
}
# case → (experts, d_ff, mesh shape, modes)
CASES = {
    "ep": (4, 64, (1, 4), ("dense", "dual", "weight", "dual+kc")),
    "tp": (6, 32, (1, 4), ("dense", "dual")),
    "dp": (4, 64, (2, 2), ("dense", "dual")),
}
RULES = {"experts": "model", "batch": "data", "mlp": "model"}
X_SHAPE = (2, 16, 32)


def config(n_experts: int, d_ff: int = 64) -> ModelConfig:
    """The smoke MoE's config; cap = 16 at 32 tokens and 8 at 16 (a data
    half), multiples of sparse_block_m, so a (E/tp, tp·cap, d) buffer
    tiles into whole capacity chunks."""
    return ModelConfig(
        name="moe_sharded", family="moe", n_layers=1, d_model=32,
        n_heads=4, n_kv_heads=4, d_ff=d_ff, vocab_size=64, mlp_type="relu",
        n_experts=n_experts, n_experts_active=1, capacity_factor=2.0,
        sparse_block_m=8, sparse_block_n=16, sparse_slice_k=16)


def _block_pruned(rng, w: np.ndarray, bk: int, bn: int) -> np.ndarray:
    """Half of each expert's (bk, bn) blocks zeroed, chosen at random."""
    e, k, n = w.shape
    keep = rng.random((e, k // bk, n // bn)) < 0.5
    mask = np.repeat(np.repeat(keep, bk, axis=1), bn, axis=2)
    return (w * mask).astype(np.float32)


def write_inputs(path, seed: int = 0) -> Dict[str, np.ndarray]:
    """Draw every case's weights and the input with numpy and save them
    to ``path`` (``.npz``); returns them."""
    rng = np.random.default_rng(seed)
    out = {"x": (rng.normal(size=X_SHAPE) * 0.3).astype(np.float32)}
    for case, (e, f, _, _) in CASES.items():
        cfg = config(e, f)
        d = cfg.d_model

        def normal(shape, std):
            return (rng.normal(size=shape) * std).astype(np.float32)
        out[f"{case}.router"] = normal((d, e), d ** -0.5)
        out[f"{case}.w_up"] = _block_pruned(
            rng, normal((e, d, f), d ** -0.5), cfg.sparse_slice_k,
            cfg.sparse_block_n)
        out[f"{case}.w_down"] = _block_pruned(
            rng, normal((e, f, d), f ** -0.5), cfg.sparse_slice_k,
            cfg.sparse_block_n)
    np.savez(path, **out)
    return out


def _moe(cfg: ModelConfig, inputs, case: str, dev):
    from repro_torch.models import moe as moem
    m = moem.MoE(cfg, device=dev, dtype=torch.float32)
    with torch.no_grad():
        for key in ("router", "w_up", "w_down"):
            getattr(m, key).copy_(torch.from_numpy(
                np.asarray(inputs[f"{case}.{key}"])))
    return m


def _taped(fn):
    from repro_torch.sparse import tape
    with tape.collect() as entries:
        y, aux = fn()
    return y, aux, [e for e in tape.summarize(entries)
                    if e["name"].startswith("moe.")]


def run_cases(inputs, dev) -> tuple:
    """Every case on this rank (the group joined): ({name: array},
    {name: tape entries or warnings})."""
    from repro_torch.launch import mesh as meshmod
    from repro_torch.models import moe as moem
    from repro_torch.models import nn as tnn
    from repro_torch.sparse import weights as spw
    x = torch.from_numpy(np.asarray(inputs["x"])).to(dev)
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, object] = {}
    meshes = {}
    for case, (e, f, shape, modes) in CASES.items():
        if shape not in meshes:
            meshes[shape] = meshmod.make_mesh(shape)
        mesh = meshes[shape]
        base = config(e, f)
        whole = _moe(base, inputs, case, dev)
        kc = dataclasses.replace(base, **MODES["dual+kc"])
        sharded = moem.shard_moe_(_moe(base, inputs, case, dev), kc, mesh,
                                  RULES)
        meta[f"{case}.elem"] = _elem_cached(sharded, kc, mesh)
        meta[f"{case}.w_up_block"] = list(sharded.w_up.shape)
        meta[f"{case}.down_ok"] = sharded.shard.down_ok
        for mode in modes:
            cfg = dataclasses.replace(base, **MODES[mode])
            sparse = mode != "dense"
            plans = (spw.plan_layer_weights(whole.weights(),
                                            slice_k=cfg.sparse_slice_k)
                     if sparse else None)
            y, aux, ent = _taped(lambda: moem.moe_forward(whole, x, cfg,
                                                          plans=plans))
            arrays[f"local.{case}.{mode}.y"] = y.cpu().numpy()
            arrays[f"local.{case}.{mode}.aux"] = aux.cpu().numpy()
            meta[f"local.{case}.{mode}.tape"] = ent
            if case == "dp":
                # each data half alone: what a data shard computes
                for h in range(2):
                    y, aux = moem.moe_forward(whole, x[h:h + 1], cfg,
                                              plans=plans)
                    arrays[f"local.{case}.{mode}.half{h}.y"] = \
                        y.cpu().numpy()
                    arrays[f"local.{case}.{mode}.half{h}.aux"] = \
                        aux.cpu().numpy()
            splans = moem.shard_plans(sharded, cfg) if sparse else None
            runs = 2 if case == "tp" else 1
            for i in range(runs):
                with warnings.catch_warnings(record=True) as caught, \
                        tnn.axis_rules(RULES, mesh=mesh):
                    warnings.simplefilter("always")
                    y, aux, ent = _taped(lambda: moem.moe_forward(
                        sharded, x, cfg, plans=splans))
                meta[f"{case}.{mode}.warnings{i}"] = [
                    str(w.message) for w in caught]
            arrays[f"{case}.{mode}.y"] = y.cpu().numpy()
            arrays[f"{case}.{mode}.aux"] = aux.cpu().numpy()
            meta[f"{case}.{mode}.tape"] = ent
    meta["blocks"] = _blocks_round_trip(meshes, dev)
    return arrays, meta


def _elem_cached(moe, cfg, mesh) -> Dict[str, bool]:
    """{"<key>@elem": equal} for every element activity a sharded MoE's
    kcondensed plans hold: whether it equals the element activity of the
    rank's weight block as the block runs (w_up/w_gate gathered over the
    data axes)."""
    from repro_torch.distributed import comm
    from repro_torch.models import moe as moem
    from repro_torch.sparse import plan as pln
    sh = moe.shard
    g_dp = comm.axis_group(mesh, sh.dp_axes) if sh.dp > 1 else None
    out = {}
    for key, a in moem.shard_plans(moe, cfg).items():
        if not key.endswith("@elem"):
            continue
        w = moe.weights()[key.split("@")[0]]
        if not key.startswith("w_down"):
            w = comm.all_gather(w, g_dp, dim=1)
        out[key] = bool(torch.equal(
            a, pln.element_activity_rhs(w, cfg.sparse_block_n)))
    return out


# specs of an (8, 4, 8) tensor whose blocks go round through
# sharding.local_slice and gather_slices on each mesh
BLOCK_SPECS = ((("data", "model"), None, None), (None, "model", None),
               ("model", None, "data"), (None, None, ("model", "data")))


def _blocks_round_trip(meshes, dev) -> list:
    """[(mesh shape, spec, block shape, gathered == whole)] for every
    mesh and :data:`BLOCK_SPECS` entry."""
    from repro_torch.distributed import sharding as shd
    t = torch.arange(8 * 4 * 8, dtype=torch.float32, device=dev).reshape(
        8, 4, 8)
    out = []
    for shape, mesh in meshes.items():
        for spec in BLOCK_SPECS:
            block = shd.local_slice(t, spec, mesh)
            back = shd.gather_slices(block.contiguous(), spec, mesh)
            out.append([list(shape), [list(e) if isinstance(e, tuple)
                                      else e for e in spec],
                        list(block.shape), bool(torch.equal(back, t))])
    return out


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
    arrays, meta = run_cases(np.load(args.inputs), dev)
    meta["backend"] = torch.distributed.get_backend()
    out = Path(args.out)
    np.savez(out / f"rank{r}.npz", **arrays)
    (out / f"rank{r}.json").write_text(json.dumps(meta))
    torch.distributed.destroy_process_group()
    return 0


def free_port() -> int:
    """A TCP port on localhost that the OS had free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(cmd: List[str], world: int, *, timeout: float,
          env: Optional[Dict[str, str]] = None, cwd=None) -> List[str]:
    """Run ``cmd`` as ``world`` ranks (the ``torchrun`` variables set, a
    port the OS picked) and wait for all of them; returns each rank's
    standard output.  Raises with every rank's output when one exits
    non-zero or ``timeout`` seconds pass (the ranks are killed)."""
    port = free_port()
    procs = []
    for r in range(world):
        e = dict(os.environ if env is None else env, RANK=str(r),
                 WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            cmd, env=e, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    outs: List[Optional[str]] = [None] * world
    failed = None
    try:
        while any(o is None for o in outs):
            for r, p in enumerate(procs):
                if outs[r] is not None:
                    continue
                try:
                    outs[r] = p.communicate(timeout=0.2)[0]
                except subprocess.TimeoutExpired:
                    continue
                if p.returncode and failed is None:
                    failed = f"rank {r} exited with {p.returncode}"
            if failed:
                break
            if time.monotonic() > deadline:
                failed = f"timed out after {timeout:.0f} s"
                break
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
            if outs[r] is None:
                outs[r] = p.communicate()[0]
    if failed:
        raise RuntimeError(f"{' '.join(cmd)}: {failed}\n" + "\n".join(
            f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outs)))
    return outs


def load(out_dir, world: int = WORLD) -> List[tuple]:
    """[(arrays, meta)] of every rank, in rank order."""
    out = Path(out_dir)
    return [(dict(np.load(out / f"rank{r}.npz")),
             json.loads((out / f"rank{r}.json").read_text()))
            for r in range(world)]


if __name__ == "__main__":
    sys.exit(main())
