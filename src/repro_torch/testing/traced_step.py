"""One sharded smoke train step on real ranks, counted by
:class:`~repro_torch.launch.roofline.StepTrace`: the real run the dry
run's fake trace of the same step (``launch.dryrun.lower`` on a fake group
of as many ranks) is held against.

Each rank builds chatglm3-6b's smoke model from seed 0, cuts it to its
blocks on a (2, 2) mesh under the train rules, and runs one step of
``RunConfig(microbatches=2)`` on ``SyntheticTokens(vocab, BATCH, SEQ,
seed=0)`` inside the trace; it prints one JSON line: its rank, the
collectives it issued, its FLOPs, bytes, argument bytes and peak live
bytes.  Run under ``torchrun``'s variables
(``repro_torch.testing.sharded_moe.spawn`` sets them)::

    python -m repro_torch.testing.traced_step [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshmod
from repro_torch.models import model_zoo
from repro_torch.models import nn as tnn

ARCH, MESH = "chatglm3-6b", (2, 2)
BATCH, SEQ = 8, 16
RC = RunConfig(microbatches=2)
SHAPE = ShapeConfig("smoke", "train", SEQ, BATCH)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = meshmod.init_distributed(args.device)
    cfg = smoke_config(ARCH)
    mesh = meshmod.make_mesh(MESH)
    rules = shd.make_rules("train")
    with tnn.axis_rules(rules, mesh=mesh):
        model = model_zoo.build_model(cfg, 0, device=dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticTokens(
            cfg.vocab_size, BATCH, SEQ, seed=0).batch_at(0).items()}
        trace, _ = dryrun.trace_step(*dryrun.train_parts(
            cfg, RC, model, batch, mesh=mesh, rules=rules))
    print(json.dumps(dict(
        rank=meshmod.rank(), collectives=trace.collectives,
        flops=trace.flops, bytes=trace.bytes,
        argument_bytes=trace.argument_bytes, peak=trace.peak)), flush=True)
    meshmod.destroy()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
