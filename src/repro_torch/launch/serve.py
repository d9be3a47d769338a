"""Serving launcher: random-weight model behind the batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch nemotron-4-340b --smoke --requests 4 [--device cpu]

Submits ``--requests`` short prompts to an :class:`~repro_torch.serving.
engine.Engine`, drains it, and prints each request's tokens and the
tokens per second.  The weights are random, drawn from seed 0.  A smoke
config runs on the default :class:`RunConfig`; a full config on the run
table's ``decode_32k`` entry for its arch (``get_run_config``), which
makes the KV pool int8 where the table sets ``kv_quant``.  It runs on the
card unless ``--device cpu`` is given, and raises without one.

Under ``torchrun`` (``WORLD_SIZE`` in the environment) every rank joins
the group (:func:`repro_torch.launch.mesh.init_distributed`: NCCL with a
card for each rank, gloo on the CPU or with ranks sharing a card), builds
the same model from seed 0, cuts its MoE layers to the host mesh
(``make_host_mesh()``: every rank on the data axis) under
``make_rules("decode")``, submits the same requests and serves them
inside ``nn.axis_rules``; only rank 0 prints.  For example, two ranks on
the CPU::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch qwen3-moe-235b-a22b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config, get_run_config, smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import device as devmod
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as meshmod
from repro_torch.models import moe as moem
from repro_torch.models import nn as tnn
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Engine, Request


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda)")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg, rc = smoke_config(args.arch), RunConfig()
    else:
        cfg = get_config(args.arch)
        rc = get_run_config(args.arch, "decode_32k")
    dev = devmod.resolve(args.device)
    scope = contextlib.nullcontext()
    sharded = "WORLD_SIZE" in os.environ
    if sharded:
        dev = meshmod.init_distributed(dev)
    model = tfm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    if sharded:
        mesh = meshmod.make_host_mesh()
        rules = shd.make_rules("decode")
        moem.shard_moe_layers_(model, cfg, mesh, rules)
        scope = tnn.axis_rules(rules, mesh=mesh)
    with scope:
        engine = Engine(model, cfg, slots=args.slots, capacity=args.capacity,
                        rc=rc, device=dev)
        t0 = time.perf_counter()
        for uid in range(args.requests):
            engine.submit(Request(uid=uid, prompt=[1 + uid, 2, 3],
                                  max_new_tokens=args.max_new))
        done = engine.run_to_completion()
        dt = time.perf_counter() - t0
    if meshmod.rank() == 0:
        toks = sum(len(r.output) for r in done)
        for r in sorted(done, key=lambda r: r.uid):
            print(f"req {r.uid}: {r.output}")
        print(f"{toks} tokens in {dt:.1f}s ({toks / dt:.1f} tokens/s)")
    if sharded:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
