"""Deterministic synthetic token pipeline (per-host sharded, restartable):
the JAX package's ``data/pipeline.py``, which is numpy only, copied.

Every batch is a pure function of (seed, step, host_slice): restarting at
step N replays the identical stream, the property fault-tolerant training
relies on (no data-loader state to checkpoint).  Batches are numpy int32
arrays, bit-equal to the JAX package's; the launcher moves them to the
device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


class SyntheticTokens:
    """Markov-ish synthetic LM stream with a learnable structure.

    Tokens follow t_{i+1} = (a·t_i + 1 + noise) mod V, so tiny models
    actually reduce loss on it (used by the end-to-end tests).
    """

    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 *, seed: int = 0, host_index: int = 0, host_count: int = 1):
        if global_batch % host_count:
            raise ValueError(f"global batch {global_batch} is not a "
                             f"multiple of {host_count} hosts")
        self.vocab = vocab_size
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.seq = seq_len
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index]))
        b, s, v = self.local_batch, self.seq, self.vocab
        # fixed affine structure (seed-keyed, not step-keyed) so the
        # bigram rule is learnable; small noise keeps loss > 0.
        a = 1 + (self.seed % 5)
        t0 = rng.integers(0, v, (b, 1))
        noise = (rng.random((b, s + 1)) < 0.1) * rng.integers(
            1, 3, (b, s + 1))
        toks = np.zeros((b, s + 1), np.int64)
        toks[:, :1] = t0
        for i in range(s):
            toks[:, i + 1] = (a * toks[:, i] + 1 + noise[:, i]) % v
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """One-batch lookahead on a worker thread (overlap host/step)."""

    def __init__(self, source: SyntheticTokens, start_step: int = 0):
        import queue
        import threading
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()

        def work():
            step = start_step
            while not self._stop.is_set():
                self._q.put((step, source.batch_at(step)))
                step += 1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def next(self) -> Tuple[int, Dict[str, np.ndarray]]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
