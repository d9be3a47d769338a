"""Fault tolerance: checkpoint manager, restart logic, straggler monitor
(the JAX package's ``training/fault_tolerance.py``).

Step-granular checkpoints with atomic commit and retention, deterministic
restart (the data pipeline is keyed by step, so a restarted job replays
the exact token stream), and a straggler monitor that flags slow steps
against a rolling median: on a real deployment the flag feeds the
scheduler's drain/replace decision; here it is surfaced in metrics and
tested with an injected clock.

A sharded state is saved with ``shardings`` and ``mesh``: the leaves are
gathered whole on the main thread (a collective on the saver's thread
would interleave with the next step's collectives), rank 0 writes them
on its saver's thread, and :meth:`CheckpointManager.wait` is where the
ranks meet; ``restore_latest(..., shardings=, mesh=)`` hands each rank its
blocks on any mesh.  Only rank 0 writes and collects garbage.
"""
from __future__ import annotations

import os
import re
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch.distributed as dist

from repro_torch.training import checkpoint as ckpt


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._saver = ckpt.AsyncSaver() if async_save else None
        self._sharded = False

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None, *,
             shardings: Any = None, mesh=None) -> None:
        """Save ``tree`` as step ``step``; a sharded tree (the rank's blocks
        under ``shardings`` on ``mesh``) whole, every rank calling."""
        if mesh is not None:
            self._sharded = True
            host = ckpt.gather_to_host(tree, shardings, mesh)
            if host is None:
                return
        else:
            # device→host copy before the next step updates the state in
            # place
            host = ckpt.to_host(tree)

        def do():
            ckpt.save(self._path(step), host, step=step, extra=extra)
            self._gc()

        if self._saver is not None:
            self._saver.submit(do)
        else:
            do()

    def wait(self):
        """Wait for the last save; after a sharded save every rank calls
        it, and the ranks meet here once rank 0's write is done."""
        if self._saver is not None:
            self._saver.wait()
        if self._sharded:
            dist.barrier()

    def restore_latest(self, like: Any, *, device=None, shardings: Any = None,
                       mesh=None) -> Optional[Tuple[Any, Dict]]:
        """The latest checkpoint in the structure of ``like`` on ``device``
        (None: the card), with its manifest; None when there is none.
        With ``shardings`` and ``mesh``, each leaf is this rank's block
        (``like`` holds the blocks)."""
        if mesh is not None:
            self._sharded = True
            self.wait()
        steps = self.steps()
        if not steps:
            return None
        return ckpt.load(self._path(steps[-1]), like, device=device,
                         shardings=shardings, mesh=mesh)

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)


class StragglerMonitor:
    """Rolling-median step timer; flags steps slower than ratio×median.

    ``clock`` is injectable (defaults to ``time.monotonic``) so tests, and
    deployments with their own time source, drive it deterministically.
    """

    def __init__(self, window: int = 32, ratio: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window = window
        self.ratio = ratio
        self.clock = clock
        self.times: List[float] = []
        self.flags = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = self.clock()
        return self

    def __exit__(self, *exc):
        dt = self.clock() - self._t0
        hist = sorted(self.times[-self.window:])
        if hist:
            med = hist[len(hist) // 2]
            if dt > self.ratio * med:
                self.flags += 1
        self.times.append(dt)
        return False

    @property
    def median(self) -> float:
        hist = sorted(self.times[-self.window:])
        return hist[len(hist) // 2] if hist else 0.0


def run_with_restarts(train_once, *, max_restarts: int = 3,
                      on_restart=None) -> Any:
    """Drive ``train_once()`` to completion across induced failures.

    ``train_once`` resumes from the latest checkpoint internally; any
    exception short of SystemExit triggers a restart (up to the budget),
    the pattern a real cluster supervisor applies per job.
    """
    for attempt in range(max_restarts + 1):
        try:
            return train_once()
        except SystemExit:
            raise
        except Exception:
            if attempt == max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt)
    raise AssertionError("unreachable")
