#!/usr/bin/env python3
"""Traffic D's engine tokens/s for one checkout of the port, to compare two
trees on one card.

    python3 tools/engine_decode_ab.py --src PATH/src --label parent
    python3 tools/engine_decode_ab.py --label change

Serves ``chip_smoke.py``'s traffic D (8 requests of 17 to 256 prompt
tokens, 16 new tokens each, 4 slots x 4096) through the ``Engine`` of the
``repro_torch`` package under ``--src`` (default: this checkout's), on
full-width nemotron-4-340b at 2 layers with random bf16 weights from seed
0, in each of ``--modes``: one warm-up run, then ``--repeat`` timed runs,
each on a new engine.  The decode step is host-bound there (planning and
the Python between launches), so this is the rate a change to the per-call
host path moves.  Prints one JSON line per timed run: tokens/s, the wall
time, the median prefill and decode call (each from a synchronize to the
host read of its tokens) and the card's name and power limit.  The tokens
of every run of a mode must agree.  Run the trees alternately (parent,
change, change, parent) in one call to the card; needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory of the checkout to measure")
    ap.add_argument("--label", default="this tree",
                    help="the tree's name in the printed lines")
    ap.add_argument("--modes", default="dense,dual",
                    help="comma-separated engine modes of chip_smoke.py")
    ap.add_argument("--repeat", type=int, default=5,
                    help="timed runs per mode, after one warm-up")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("engine_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(ROOT))           # chip_smoke's traffic D helpers
    sys.path.insert(0, str(src))
    import chip_smoke as cs
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import build
    from repro_torch.serving.engine import Engine
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch imported from "
                           f"{repro_torch.__file__}, not from {src}")
    build.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = dataclasses.replace(get_config(cs.ARCH), n_layers=cs.N_LAYERS)
    model = cs.make_model(torch, cfg)
    prompts = cs.traffic_d_prompts(torch, cfg)
    n_tok = cs.D_NEW * len(prompts)
    for mode in args.modes.split(","):
        c = dataclasses.replace(cfg, **cs.ENGINE_MODES[mode])
        first = None
        for run in range(args.repeat + 1):
            eng = Engine(model, c, serve=ServeConfig(
                slots=cs.D_SLOTS, capacity=cs.D_CAPACITY))
            done, wall, times = cs.serve_traffic_d(torch, eng, prompts)
            tokens = [done[u].output for u in sorted(done)]
            if first is None:
                first = tokens
            elif tokens != first:
                raise AssertionError(f"{args.label} {mode}: run {run}'s "
                                     "tokens differ from the warm-up's")
            if run == 0:
                continue
            print(json.dumps({
                "tree": args.label, "mode": mode, "run": run,
                "tokens_per_s": n_tok / wall * 1e3, "wall_ms": wall,
                "prefill_median_ms": statistics.median(times["prefill"]),
                "decode_median_ms": statistics.median(times["decode"]),
                "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
