"""Admission/eviction scheduling + physical page allocation.

Host-side control-plane policy for the continuous-batching engine: which
queued request is admitted when a slot frees, which active request is
preempted when the page pool runs dry, and which physical pages back
which logical cache blocks.  Pure Python over request metadata — the
prefill/decode steps never see any of it except through the block tables
the engine pushes to the device.  The JAX package's
``serving/scheduler.py``, the same decisions in the same order.

Two policies:

* ``fcfs`` — admit in arrival order; preempt the most recently admitted
  request (LIFO, vLLM's recompute-preemption default: the youngest
  request has the least work to redo).
* ``cost`` — admit the *cheapest* queued request first and preempt the
  most expensive active one, where cost comes from a caller-provided
  signal.  The engine wires this to the StepCounts tape: one
  tape-collected prefill per request counts the scheduled steps its
  prompt actually needs under the active sparse mode, so a prompt whose
  activations are mostly zero-blocks (cheap on the dual-side kernels) is
  admitted ahead of a dense one of equal length (falls back to prompt
  length in dense mode, where nothing is routed).

Costs are memoized per request uid — the tape prefill runs once per
request, not once per scheduling decision.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

POLICIES = ("fcfs", "cost")


class PageAllocator:
    """Free-list allocator over physical pages 1..n (0 is the trash page).

    Pages freed by a retired or preempted request return to the tail of
    the free list and recycle across requests — the engine's occupancy
    bitmaps guarantee a page's stale contents are never scheduled by its
    next owner.
    """

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: Deque[int] = deque(range(1, n_pages + 1))
        self._free_set = set(self._free)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages, or None (nothing consumed) if the pool can't cover it."""
        if n <= 0:
            raise ValueError(f"PageAllocator.alloc({n}): page count must "
                             "be positive")
        if n > len(self._free):
            return None
        out = [self._free.popleft() for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def free(self, pages: Sequence[int]) -> None:
        """Return pages to the pool; raises on double-frees and ids
        outside 1..n_pages (the trash page 0 is never allocatable)."""
        for p in pages:
            if not 1 <= p <= self.n_pages:
                raise ValueError(f"PageAllocator.free({p}): page id "
                                 f"outside 1..{self.n_pages}")
            if p in self._free_set:
                raise ValueError(f"PageAllocator.free({p}): double free "
                                 "(page already on the free list)")
            self._free_set.add(p)
            self._free.append(p)

    def check(self) -> dict:
        """Free-list uniqueness + range (the invariant validators' hook)."""
        assert len(self._free) == len(self._free_set) \
            and set(self._free) == self._free_set, \
            "free list and free set disagree (duplicate or lost pages)"
        assert all(1 <= p <= self.n_pages for p in self._free), \
            f"free page id outside 1..{self.n_pages}"
        return {"free": len(self._free), "total": self.n_pages}


class Scheduler:
    """Admission queue + preemption policy over engine requests.

    ``cost_fn(request) -> float`` is consulted lazily (and memoized by
    ``request.uid``) only under the ``cost`` policy.
    """

    def __init__(self, policy: str = "fcfs",
                 cost_fn: Optional[Callable] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.policy = policy
        self.cost_fn = cost_fn
        self.queue: Deque = deque()
        self._cost: Dict[int, float] = {}

    def __len__(self) -> int:
        return len(self.queue)

    def submit(self, req) -> None:
        self.queue.append(req)

    def requeue(self, req) -> None:
        """Preempted request: back to the head (it already waited once)."""
        self.queue.appendleft(req)

    def cost(self, req) -> float:
        if req.uid not in self._cost:
            self._cost[req.uid] = (float(self.cost_fn(req))
                                   if self.cost_fn else
                                   float(len(req.prompt)))
        return self._cost[req.uid]

    def pop_next(self, max_pages: Optional[int] = None,
                 pages_of: Optional[Callable] = None,
                 now: Optional[int] = None):
        """Next request to admit, or None.

        ``max_pages``/``pages_of`` optionally constrain admission to
        requests whose prefill fits the free pool right now; a request
        that doesn't fit stays queued (fcfs blocks on it — head-of-line
        order is the policy's contract; cost skips over it).  ``now``
        (the engine tick) skips requests whose ``not_before`` backoff
        stamp is still in the future — a request backing off after a
        failed page allocation never blocks the fcfs head.
        """
        if not self.queue:
            return None

        def eligible(r) -> bool:
            return now is None or getattr(r, "not_before", 0) <= now

        def fits(r) -> bool:
            return (max_pages is None or pages_of is None
                    or pages_of(r) <= max_pages)

        cand = [r for r in self.queue if eligible(r)]
        if not cand:
            return None
        if self.policy == "cost":
            order = sorted(cand, key=lambda r: (self.cost(r), r.uid))
            for req in order:
                if fits(req):
                    self.queue.remove(req)
                    return req
            return None
        if fits(cand[0]):
            self.queue.remove(cand[0])
            return cand[0]
        return None

    def pick_victim(self, active: Sequence[Tuple[int, object, int]]
                    ) -> Optional[int]:
        """Slot to preempt from ``(slot, request, admitted_tick)`` rows.

        fcfs evicts the most recently admitted (LIFO recompute); cost
        evicts the most expensive (ties broken toward youngest).
        """
        if not active:
            return None
        if self.policy == "cost":
            slot, _, _ = max(active,
                             key=lambda a: (self.cost(a[1]), a[2]))
            return slot
        slot, _, _ = max(active, key=lambda a: a[2])
        return slot


def pack_prefills(reqs: Sequence, *, bucket: int, max_batch: int,
                  pack: bool = True,
                  length_of: Optional[Callable] = None
                  ) -> List[Tuple[int, List]]:
    """Group admitted requests into batched prefill calls.

    Returns ``[(padded_len, [requests...]), ...]``: each group runs as
    one prefill of shape ``(len(group), padded_len)``, so prefill shapes
    are keyed by the bucket geometry instead of raw prompt lengths.
    ``pack=False`` (MoE / SSM stacks, where padding or
    co-batching perturbs expert capacity or recurrent state) degrades
    to one exact-length single-request call each.  ``length_of``
    overrides the prompt-length accessor (the engine passes the resume
    prompt of preempted requests).
    """
    if length_of is None:
        length_of = lambda r: len(r.prompt)  # noqa: E731
    if not pack:
        return [(length_of(r), [r]) for r in reqs]
    groups: Dict[int, List] = {}
    for r in reqs:
        lpad = -(-length_of(r) // bucket) * bucket
        groups.setdefault(lpad, []).append(r)
    out: List[Tuple[int, List]] = []
    for lpad in sorted(groups):
        rs = groups[lpad]
        for i in range(0, len(rs), max_batch):
            out.append((lpad, rs[i:i + max_batch]))
    return out
