#!/usr/bin/env python3
"""Where one traffic-J train step's device time goes.

    python3 tools/train_step_profile.py

Builds ``chip_smoke.py``'s traffic J (full-width chatglm3-6b cut to 4 of
its 28 layers, float32 masters from seed 0, its ``train_4k`` run config:
8 microbatches of one 4096-token sequence, adamw, bf16 compute copies,
remat full) on the card with TF32 off, runs one warm-up step, then one
step under ``torch.profiler`` and prints its kernels' device time by
category (float32 and bf16 GEMMs, elementwise, reductions, copies) and by
kernel, the sum beside the step's wall time (the device's idle share,
unclamped: it goes below 0 where kernels overlap), then two steps with TF32 on beside two with it off, in turns.  Needs one
NVIDIA GPU; prints the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config, get_run_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as tl  # noqa: E402

ARCH, LAYERS, BATCH, SEQ = "chatglm3-6b", 4, 8, 4096


def category(name: str) -> str:
    if "gemm" in name and ("f32f32" in name or "sgemm" in name):
        return "GEMM float32"
    if "nvjet" in name or "gemm" in name:
        return "GEMM bf16"
    if "copy" in name or "Memcpy" in name:
        return "copies and casts"
    if "reduce_kernel" in name:
        return "reductions"
    if "elementwise" in name:
        return "elementwise"
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        print("train_step_profile: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(ARCH), n_layers=LAYERS)
    rc = get_run_config(ARCH, "train_4k")
    model = model_zoo.build_model(cfg, 0)
    ostate = opt.init_opt_state(dict(model.named_parameters()), rc)
    data = SyntheticTokens(cfg.vocab_size, BATCH, SEQ, seed=0)
    step = tl.make_train_step(cfg, rc)
    count = [0]

    def run():
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch_at(count[0]).items()}
        count[0] += 1
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(model, ostate, None, batch)[3]["loss"].item()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, loss

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, loss = run()
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.device_time_total / 1e3
    total = sum(per.values())
    print(f"{smi}; {cfg.name}, {LAYERS} layers, {BATCH} x {SEQ} tokens, "
          f"{rc.microbatches} microbatches, remat {rc.remat}, TF32 off: "
          f"profiled step {wall:.1f} ms (loss {loss:.4f}); kernels "
          f"{total:.1f} ms of device time, idle share "
          f"{1 - total / wall:.1%}")
    cats = {}
    for name, ms in per.items():
        cats[category(name)] = cats.get(category(name), 0.0) + ms
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:18s} {ms:9.1f} ms  {ms / total:6.1%}")
    print("kernels:")
    for name, ms in sorted(per.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms:9.1f} ms  {name[:100]}")
    times = {False: [], True: []}
    for tf32 in (False, True, True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        times[tf32].append(run()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"steps with TF32 off {[round(t, 1) for t in times[False]]} ms, "
          f"on {[round(t, 1) for t in times[True]]} ms; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
