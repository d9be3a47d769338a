"""Multi-pod dry run: trace every (arch × shape × mesh) cell on fake tensors.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell's
step against abstract inputs on 512 host devices and reads XLA's memory
and cost analyses.  Here each cell's step runs once, eagerly, as rank 0
of a fake process group of 256 (16×16) or 512 (2×16×16) ranks, on fake
tensors (``FakeTensorMode``: shapes and dtypes, no storage), inside
:class:`~repro_torch.launch.roofline.StepTrace`, which counts its FLOPs,
bytes, collectives and live bytes.  Nothing is allocated, so a
full-width model of any mesh traces on one host.

* train cells: every float32 master, moment and gradient the rank's
  block under the train rules (``sharding.param_pspecs``,
  ``shard_params_``), the sharded ``make_train_step``;
* prefill and decode cells: placed as ``launch/serve.py`` places them
  under a group: the MoE cut by ``moe.shard_moe_layers_``, dense weights
  (bf16), the batch and the caches whole on each rank (``placement`` in
  the result says so); a decode step writes the last slot of caches of
  ``seq_len`` slots.

A step that reads a tensor's value on the host (``float(t)``, ``.item()``,
``.tolist()``) cannot run on fake tensors: the traced paths read none.

Nothing is allocated, so no card is needed: ``device`` (``--device``)
names the device type of the fake tensors, ``cuda`` by default (on a host
whose PyTorch has CUDA; ``cpu`` elsewhere, as the tests pass it).
Several cells trace at once, each in a process of its own, as many as
the host has cores.

Usage::

  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --all --mesh both --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import (SHAPES_BY_NAME, get_config, get_run_config,
                                 list_archs, runnable_shapes)
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import costmodel as cm
from repro_torch.launch import mesh as meshmod
from repro_torch.launch import roofline as rl
from repro_torch.models import cache as kvc
from repro_torch.models import model_zoo
from repro_torch.models import moe as moem
from repro_torch.models import nn as tnn
from repro_torch.serving import serve_loop
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import make_train_step

TRAIN_PLACEMENT = ("every master, moment and gradient the rank's block "
                   "under the train rules")
SERVE_PLACEMENT = ("dense weights, batch and caches whole on each rank; "
                   "MoE cut by shard_moe_layers_")


@dataclasses.dataclass
class Lowered:
    """One step ready to trace: ``step(*args)`` in ``fake_mode`` (under
    ``rules`` on the mesh, when it has one); ``outputs(result)`` picks
    the step's output tensors; :meth:`close` leaves the fake group if
    the cell joined it."""
    step: Callable
    args: Tuple
    outputs: Callable
    fake_mode: Any
    rules: Dict[str, Any]
    owns_group: bool

    def close(self) -> None:
        if self.owns_group:
            meshmod.destroy()
            self.owns_group = False


def join_fake_group(world: int) -> bool:
    """Join a fake process group of ``world`` ranks as rank 0 (its
    collectives move nothing) unless a group is in force; True if it
    joined."""
    if dist.is_initialized():
        return False
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return True


def fake_like(tree, device: torch.device, dtype=None):
    """``tree`` with every meta tensor replaced by an empty one on
    ``device`` (a fake tensor under a fake mode), floating ones cast to
    ``dtype`` when given; lists, tuples, dicts and dataclasses of
    tensors are rebuilt."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            dt = (dtype if dtype is not None and x.is_floating_point()
                  else x.dtype)
            return torch.empty(x.shape, dtype=dt, device=device)
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(conv(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: conv(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        return x
    return conv(tree)


def fake_model(cfg: ModelConfig, device: torch.device, dtype=None):
    """``model_zoo.abstract_params``' meta model with every parameter
    and buffer an empty tensor on ``device`` (in ``dtype`` when given)."""
    model, _ = model_zoo.abstract_params(cfg)
    named = list(model.named_parameters()) + list(model.named_buffers())
    for name, t in named:
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        new = fake_like(t, device, dtype)
        if isinstance(t, torch.nn.Parameter):
            setattr(mod, attr, torch.nn.Parameter(
                new, requires_grad=t.requires_grad))
        else:
            mod._buffers[attr] = new
    return model


def _filled(cache, kind: str, pos: int):
    """A decode cell's cache of a layer of ``kind``: a self-attention
    cache written up to ``pos``, a cross cache full."""
    if isinstance(cache, kvc.EncDecCache):
        return kvc.EncDecCache(kv=_filled(cache.kv, "attn", pos),
                               cross_kv=_filled(cache.cross_kv, "cross", 0))
    if isinstance(cache, kvc.KVCache):
        return dataclasses.replace(
            cache, pos=cache.capacity if kind == "cross" else pos)
    return cache


def train_parts(cfg: ModelConfig, rc: RunConfig, model, batch, *,
                mesh=None, rules=None) -> Tuple[Callable, Tuple, Callable]:
    """(step, args, outputs) of ``model``'s train step on ``batch``: on
    ``mesh`` every master cut to the rank's block under ``rules``
    (``shard_params_``) and the sharded step, else the one-device step;
    ``outputs(result)`` picks the step's output tensors."""
    if mesh is not None:
        specs = shd.param_pspecs(model, cfg, rules, mesh)
        shd.shard_params_(model, specs, mesh, cfg=cfg, rules=rules)
        step = make_train_step(cfg, rc, param_pspecs=specs, mesh=mesh)
    else:
        step = make_train_step(cfg, rc)
    ostate = opt.init_opt_state(dict(model.named_parameters()), rc)

    def outputs(res):
        model, ostate, _, metrics = res
        return dict(model.named_parameters()), ostate, metrics
    return step, (model, ostate, None, batch), outputs


def serve_parts(cfg: ModelConfig, rc: RunConfig, shape: ShapeConfig, model,
                batch, caches, *, mesh=None, rules=None
                ) -> Tuple[Callable, Tuple, Callable]:
    """(step, args, outputs) of ``model``'s prefill or decode step (by
    ``shape.kind``): the MoE cut by ``shard_moe_layers_`` on ``mesh``, the
    rest whole; a decode step writes the last slot of ``caches``."""
    if mesh is not None:
        moem.shard_moe_layers_(model, cfg, mesh, rules)
    if shape.kind == "prefill":
        return (serve_loop.make_prefill_step(cfg, rc),
                (model, batch, caches), lambda res: res)
    pos = shape.seq_len - 1
    state = serve_loop.DecodeState(
        caches=[_filled(c, cfg.layer_kind(i % cfg.period), pos)
                for i, c in enumerate(caches)],
        last_token=batch["tokens"].to(torch.int64), pos=pos)
    return (serve_loop.make_decode_step(cfg, rc), (model, state),
            lambda res: res)


def lower(cfg: ModelConfig, rc: RunConfig, shape: ShapeConfig, *,
          device=None, mesh=None, rules=None) -> Lowered:
    """One step of ``cfg`` at ``shape`` on fake tensors on ``device``
    (None: the card's device type): the full-width model of
    ``model_zoo.abstract_params`` (float32 masters to train, bf16 weights
    to serve), its inputs from ``input_specs``/``cache_specs``.  On
    ``mesh`` (a group must be in force) placed by ``rules``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = torch.device("cuda" if device is None else device)
    fake_mode = FakeTensorMode()
    scope = (tnn.axis_rules(rules, mesh=mesh) if mesh is not None
             else contextlib.nullcontext())
    with fake_mode, scope:
        batch = fake_like(model_zoo.input_specs(cfg, shape), dev)
        if shape.kind == "train":
            parts = train_parts(cfg, rc, fake_model(cfg, dev), batch,
                                mesh=mesh, rules=rules)
        else:
            caches = fake_like(model_zoo.cache_specs(
                cfg, shape, quantized=rc.kv_quant), dev)
            parts = serve_parts(cfg, rc, shape,
                                fake_model(cfg, dev, torch.bfloat16), batch,
                                caches, mesh=mesh, rules=rules)
    return Lowered(*parts, fake_mode=fake_mode, rules=rules,
                   owns_group=False)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               rc_override: Optional[RunConfig] = None, device=None
               ) -> Tuple[Lowered, Any, Dict[str, Any], ModelConfig,
                          RunConfig, ShapeConfig]:
    """Build one cell on fake tensors on ``device`` (None: the card's
    device type; ``"cpu"`` for CPU tensors): joins a fake group of 256
    or 512 ranks as rank 0 if none is in force, builds the production
    mesh and the step's arguments (:func:`lower`).  Returns (lowered,
    mesh, metadata, cfg, rc, shape); ``lowered.close()`` leaves a group
    it joined."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    rc = rc_override or get_run_config(arch, shape_name)
    owns = join_fake_group(512 if multi_pod else 256)
    try:
        mesh = meshmod.make_production_mesh(multi_pod=multi_pod)
        kind = "long" if shape.name == "long_500k" else shape.kind
        rules = shd.make_rules(kind, multi_pod=multi_pod)
        meta_model, _ = model_zoo.abstract_params(cfg)
        meta = dict(arch=arch, shape=shape_name,
                    mesh="2x16x16" if multi_pod else "16x16",
                    kind=shape.kind,
                    n_params=sum(p.numel() for p in meta_model.parameters()),
                    seq_len=shape.seq_len, global_batch=shape.global_batch,
                    placement=(TRAIN_PLACEMENT if shape.kind == "train"
                               else SERVE_PLACEMENT))
        lowered = lower(cfg, rc, shape, device=device, mesh=mesh,
                        rules=rules)
    except BaseException:
        if owns:
            meshmod.destroy()
        raise
    lowered.owns_group = owns
    return lowered, mesh, meta, cfg, rc, shape


def trace_step(step: Callable, args: Tuple, outputs: Callable
               ) -> Tuple[rl.StepTrace, float]:
    """Run ``step(*args)`` once inside a :class:`StepTrace` with its
    arguments counted (real or fake tensors; under the caller's rules
    and fake mode); returns (the trace, its seconds)."""
    trace = rl.StepTrace()
    t0 = time.perf_counter()
    trace.add_arguments(args)
    with trace:
        res = step(*args)
    trace.set_outputs(outputs(res))
    return trace, time.perf_counter() - t0


def trace_lowered(lowered: Lowered, mesh=None
                  ) -> Tuple[rl.StepTrace, float]:
    """:func:`trace_step` of a lowered step in its fake mode (under its
    rules on ``mesh``)."""
    scope = (tnn.axis_rules(lowered.rules, mesh=mesh) if mesh is not None
             else contextlib.nullcontext())
    with lowered.fake_mode, scope:
        return trace_step(lowered.step, lowered.args, lowered.outputs)


def analyze(lowered: Lowered, mesh, meta: Dict[str, Any], cfg: ModelConfig,
            shape: ShapeConfig, rc: RunConfig) -> Dict[str, Any]:
    trace, trace_s = trace_lowered(lowered, mesh)
    sizes = shd.mesh_sizes(mesh)
    n_dev = 1
    for s in sizes.values():
        n_dev *= s
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    tp = sizes.get("model", 1)

    # traced numbers: one device's whole step (an eager step runs every
    # layer and microbatch, where XLA's cost_analysis counts a loop body
    # once); the analytic model gives the roofline terms, as in the JAX
    # package
    cost = rl.cost_summary(trace, n_dev)
    mem = rl.memory_summary(trace)
    coll = rl.collective_bytes(trace.collectives)
    ana = cm.step_costs(cfg, shape, rc, dp=dp, tp=tp)
    terms = rl.roofline(ana["flops_per_device"],
                        ana["hbm_bytes_per_device"],
                        ana["coll_bytes_per_device"])

    mf = ana["model_flops_total"]
    result = dict(meta)
    result["traced_flops_per_device"] = cost["flops_per_device"]
    result["traced_bytes_per_device"] = cost["bytes_per_device"]
    result["traced_collectives"] = coll
    result.update(mem)
    result.update({f"analytic_{k}": v for k, v in ana.items()})
    result.update(terms)
    result["model_flops"] = mf
    result["useful_flops_ratio"] = (mf / ana["hw_flops_total"]
                                    if ana["hw_flops_total"] else 0.0)
    result["trace_seconds"] = trace_s
    result["hbm_gib_per_device"] = mem["total_hbm_bytes"] / 2 ** 30
    result["fits_hbm"] = mem["total_hbm_bytes"] < rl.HBM_BYTES
    return result


def _active_params(cfg: ModelConfig, n_params: int) -> float:
    if not cfg.n_experts:
        return float(n_params)
    # expert weight fraction from config arithmetic
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    per_layer_expert = e * d * f * (3 if cfg.mlp_type == "swiglu" else 2)
    n_moe_layers = sum(1 for p in range(cfg.period)
                       if cfg.layer_is_moe(p)) * cfg.n_periods
    expert_total = per_layer_expert * n_moe_layers
    frac = cfg.n_experts_active / cfg.n_experts
    return float(n_params - expert_total + expert_total * frac)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: Optional[str] = None, verbose: bool = True,
             rc_override: Optional[RunConfig] = None, device=None
             ) -> Dict[str, Any]:
    lowered, mesh, meta, cfg, rc, shape = lower_cell(
        arch, shape_name, multi_pod=multi_pod, rc_override=rc_override,
        device=device)
    try:
        result = analyze(lowered, mesh, meta, cfg, shape, rc)
    finally:
        lowered.close()
    if verbose:
        print(json.dumps(result, indent=2, default=str))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}_{shape_name}_{meta['mesh']}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=2, default=str)
    return result


def _summary(r: Dict[str, Any]) -> str:
    return (f"  ok: fits={r['fits_hbm']} "
            f"hbm={r['hbm_gib_per_device']:.2f}GiB "
            f"flops/dev={r['analytic_flops_per_device']:.3e} "
            f"traced={r['traced_flops_per_device']:.3e} "
            f"coll={r['analytic_coll_bytes_per_device']:.3e}B "
            f"traced_coll={r['traced_collectives']['total']:.3e}B "
            f"bottleneck={r['bottleneck']} "
            f"roofline={r['roofline_s']:.4g}s "
            f"trace={r['trace_seconds']:.1f}s")


def _run_quiet(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
               device) -> Dict[str, Any]:
    return run_cell(arch, shape_name, multi_pod=multi_pod, out_dir=out_dir,
                    verbose=False, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--device", default=None,
                    help="device type of the fake tensors (default: cuda)")
    args = ap.parse_args(argv)

    cells = []
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    for arch in archs:
        shapes = ([SHAPES_BY_NAME[args.shape]] if args.shape
                  else runnable_shapes(arch))
        for s in shapes:
            if s.name == "long_500k" and not get_config(arch).subquadratic:
                print(f"SKIP {arch} long_500k (full attention)")
                continue
            cells.append((arch, s.name))

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    todo = [(arch, sname, mp) for arch, sname in cells for mp in meshes]
    failures = []

    def tag(arch, sname, mp):
        return f"{arch} × {sname} × {'2x16x16' if mp else '16x16'}"

    def report(cell, run):
        try:
            r = run()
            print(f"=== {tag(*cell)} ===\n{_summary(r)}", flush=True)
        except Exception as e:
            failures.append((tag(*cell), repr(e)))
            print(f"=== {tag(*cell)} ===\n  FAIL: {e}", flush=True)
            traceback.print_exc()

    # several cells: one process each, as many at once as the host has
    # cores, train cells first (they take longest)
    workers = min(len(todo), os.cpu_count() or 1)
    if workers == 1:
        for cell in todo:
            report(cell, lambda: _run_quiet(*cell, args.out, args.device))
    else:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor, as_completed
        todo.sort(key=lambda c: SHAPES_BY_NAME[c[1]].kind != "train")
        with ProcessPoolExecutor(workers,
                                 mp_context=mp.get_context("spawn")) as ex:
            futures = {ex.submit(_run_quiet, *cell, args.out, args.device):
                       cell for cell in todo}
            for f in as_completed(futures):
                report(futures[f], f.result)
    print(f"\n{len(todo) - len(failures)} ok, {len(failures)} failed")
    for t, e in failures:
        print("FAILED:", t, e)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
