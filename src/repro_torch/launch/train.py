"""Training launcher on one device: the JAX package's
``launch/train.py`` without its mesh.

Builds the model (float32 masters), the optimizer and a ``Prefetcher``
over ``SyntheticTokens``, resumes from the latest checkpoint in
``--ckpt-dir``, and drives the loop with checkpoints every
``--ckpt-every`` steps and a straggler monitor.  ``--smoke`` trains the
reduced config with ``RunConfig(microbatches=2, learning_rate=1e-3)``;
otherwise the arch's ``train_4k`` run config.  It runs on the card unless
``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
        --smoke --steps 20 --device cpu

``--multi-pod`` and ``--latency-flags`` wait for the port's sharding.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config, get_run_config, smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import device as devmod
from repro_torch.data.pipeline import Prefetcher, SyntheticTokens
from repro_torch.distributed.compression import init_error_feedback
from repro_torch.models import model_zoo
from repro_torch.training import optimizer as opt
from repro_torch.training.fault_tolerance import (CheckpointManager,
                                                  StragglerMonitor)
from repro_torch.training.train_loop import (load_state, make_train_step,
                                             state_tree)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = devmod.resolve(args.device)
    if args.smoke:
        cfg = smoke_config(args.arch)
        rc = RunConfig(microbatches=2, learning_rate=1e-3)
    else:
        cfg = get_config(args.arch)
        rc = get_run_config(args.arch, "train_4k")
    model = model_zoo.build_model(cfg, 0, device=dev)
    model.requires_grad_(True)
    ostate = opt.init_opt_state(dict(model.named_parameters()), rc)
    step_fn = make_train_step(cfg, rc, compress_grads=args.compress_grads)

    data = SyntheticTokens(cfg.vocab_size, args.global_batch, args.seq,
                           seed=0)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    mon = StragglerMonitor()

    restored = mgr.restore_latest(state_tree(model, ostate), device=dev)
    start = 0
    if restored is not None:
        st, manifest = restored
        ostate, start = load_state(model, st), manifest["step"]
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
            if i % 10 == 0:
                print(f"step {i:4d}  loss {float(m['loss']):.3f}  "
                      f"gnorm {float(m['grad_norm']):.2f}  "
                      f"stragglers {mon.flags}")
            if (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, state_tree(model, ostate))
    finally:
        pre.close()
        mgr.wait()
    print("training complete")


if __name__ == "__main__":
    main()
