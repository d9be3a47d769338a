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
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config, get_run_config, smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import device as devmod
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
    model = tfm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    engine = Engine(model, cfg, slots=args.slots, capacity=args.capacity,
                    rc=rc, device=dev)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        engine.submit(Request(uid=uid, prompt=[1 + uid, 2, 3],
                              max_new_tokens=args.max_new))
    done = engine.run_to_completion()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    for r in sorted(done, key=lambda r: r.uid):
        print(f"req {r.uid}: {r.output}")
    print(f"{toks} tokens in {dt:.1f}s ({toks / dt:.1f} tokens/s)")


if __name__ == "__main__":
    main()
