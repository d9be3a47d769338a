"""Per-layer StepCounts collection.

While a tape is active the dispatch records one entry per routed matmul
(a grouped matmul's problems sum into one entry): the *counted* schedule
(StepCounts: dense vs sparse steps) and the *executed* step count — what
the chosen compute path ran.  The dense
matmul computes every step, so ``executed == dense``; the kernels walk the
condensed schedule, so ``executed == sparse``.  With no tape installed,
recording is a no-op.  The port runs eagerly, so every decode step's
entries are concrete.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Tuple

from repro_torch.core import stats

Entry = Tuple[str, stats.StepCounts, object]  # (name, counted, executed)

_TAPE: contextvars.ContextVar[Optional[List[Entry]]] = \
    contextvars.ContextVar("sparse_stats_tape", default=None)


@contextlib.contextmanager
def collect():
    """Install a fresh tape; yields the list entries are appended to."""
    entries: List[Entry] = []
    token = _TAPE.set(entries)
    try:
        yield entries
    finally:
        _TAPE.reset(token)


@contextlib.contextmanager
def suppress():
    """Deactivate the tape for a region (recording becomes a no-op).

    The sharded MoE runs its expert products with ``collect_stats=True``
    under ``suppress()``, sums the returned StepCounts over the mesh, and
    records the totals after the block, so that the tape holds one
    mesh-total entry per projection instead of each rank's share."""
    token = _TAPE.set(None)
    try:
        yield
    finally:
        _TAPE.reset(token)


def active() -> bool:
    return _TAPE.get() is not None


def record(name: str, steps: stats.StepCounts, executed=None) -> None:
    """Append one routed-matmul entry (``executed=None``: dense ran)."""
    entries = _TAPE.get()
    if entries is not None:
        entries.append((name, steps, executed))


def summarize(entries: List[Entry]) -> List[dict]:
    """Per-entry dicts (name, dense, sparse, executed, skipped, speedup)."""
    out = []
    for name, sc, executed in entries:
        dense, sparse = int(sc.dense), int(sc.sparse)
        out.append({
            "name": name,
            "dense_steps": dense,
            "sparse_steps": sparse,
            "executed_steps": dense if executed is None else int(executed),
            "tiles_skipped": int(sc.tiles_skipped),
            "speedup": dense / max(sparse, 1),
        })
    return out
