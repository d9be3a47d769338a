"""Production training launcher: the JAX package's ``launch/train.py`` on
``torch.distributed``.

Builds the mesh, resolves the train rules, places every float32 master
and its optimizer state on the rank as its block under the rules'
spec, and drives the loop with checkpoints every ``--ckpt-every`` steps,
a straggler monitor and restart-safe resumption (onto any mesh).  Under
``torchrun`` it joins the group (:func:`repro_torch.launch.mesh.
init_distributed`); without it, it runs as a group of one.  ``--smoke``
trains the reduced config with ``RunConfig(microbatches=2,
learning_rate=1e-3)`` on the host mesh (every rank on ``data``);
otherwise the arch's ``train_4k`` run config on the production mesh,
16×16, or 2×16×16 with ``--multi-pod``, which needs that many ranks.
Every rank builds the model from seed 0 and keeps its blocks: FSDP
splits ``embed`` over ``data`` (``("pod", "data")`` with
``--multi-pod``), ``model`` splits heads, ``mlp``, vocab and experts.
Each rank computes its rows of the global batch; rank 0 prints.  It runs
on the card unless ``--device cpu`` is given:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch chatglm3-6b --smoke --steps 20 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_run_config, smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticTokens
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compression import init_error_feedback
from repro_torch.launch import mesh as meshmod
from repro_torch.models import model_zoo
from repro_torch.models import nn as tnn
from repro_torch.training import optimizer as opt
from repro_torch.training.fault_tolerance import (CheckpointManager,
                                                  StragglerMonitor)
from repro_torch.training.train_loop import (load_state, make_train_step,
                                             state_pspecs, state_tree)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config + host mesh")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    owned = not dist.is_initialized()
    dev = meshmod.init_distributed(args.device)
    if args.smoke:
        cfg = smoke_config(args.arch)
        mesh = meshmod.make_host_mesh()
        rc = RunConfig(microbatches=2, learning_rate=1e-3)
    else:
        cfg = get_config(args.arch)
        mesh = meshmod.make_production_mesh(multi_pod=args.multi_pod)
        rc = get_run_config(args.arch, "train_4k")
    rules = shd.make_rules("train", multi_pod=args.multi_pod)
    lead = meshmod.rank() == 0

    with tnn.axis_rules(rules, mesh=mesh):
        model = model_zoo.build_model(cfg, 0, device=dev)
        specs = shd.param_pspecs(model, cfg, rules, mesh)
        shd.shard_params_(model, specs, mesh, cfg=cfg, rules=rules)
        ostate = opt.init_opt_state(dict(model.named_parameters()), rc)
        step_fn = make_train_step(cfg, rc, compress_grads=args.compress_grads,
                                  param_pspecs=specs, mesh=mesh)

        data = SyntheticTokens(cfg.vocab_size, args.global_batch, args.seq,
                               seed=0)
        mgr = CheckpointManager(args.ckpt_dir, keep=2)
        mon = StragglerMonitor()
        place = dict(shardings=state_pspecs(specs, ostate), mesh=mesh)

        restored = mgr.restore_latest(state_tree(model, ostate), device=dev,
                                      **place)
        start = 0
        if restored is not None:
            st, manifest = restored
            ostate, start = load_state(model, st), manifest["step"]
            if lead:
                print(f"resumed from step {start}")

        ef = (init_error_feedback(dict(model.named_parameters()))
              if args.compress_grads else None)
        pre = Prefetcher(data, start_step=start)
        try:
            for i in range(start, args.steps):
                _, host_batch = pre.next()
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in host_batch.items()}
                with mon:
                    model, ostate, ef, m = step_fn(model, ostate, ef, batch)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                if i % 10 == 0 and lead:
                    print(f"step {i:4d}  loss {float(m['loss']):.3f}  "
                          f"gnorm {float(m['grad_norm']):.2f}  "
                          f"stragglers {mon.flags}")
                if (i + 1) % args.ckpt_every == 0:
                    mgr.save(i + 1, state_tree(model, ostate), **place)
        finally:
            pre.close()
            mgr.wait()
    if lead:
        print("training complete")
    if owned:
        meshmod.destroy()


if __name__ == "__main__":
    main()
