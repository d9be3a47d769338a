"""Deterministic, seeded fault injection (the JAX package's
``testing/faults.py``).

Every fault class the serving stack must degrade gracefully under is a
named, context-manager-scoped patch point::

    with faults.inject("kernel_matmul"):
        ...            # every K1/K2 wrapper call raises

Fault kinds
-----------
``kernel_matmul``     the K1/K2 wrappers (``bitmap_spgemm_planned`` /
                      ``bitmap_spgemm_kfused_planned``, looked up on
                      their module by the dispatch at each call) raise
                      :class:`FaultInjected`; the OpSite quarantine
                      catches it, on the card as on the CPU.
``kernel_grouped``    the same for K3/K4 (decode attention, MoE).
``nan_activation``    ``repro_torch.sparse.activation.activate`` (which
                      the MLP and the MoE look up on its module) poisons
                      element 0 of its output with NaN at the rate.
``nan_logits``        cooperative: the engine reads :func:`spec` at
                      construction and NaNs the decode logits of the
                      poisoned request uids (:meth:`Fault.poisons`).
``page_alloc``        ``PageAllocator.alloc`` returns ``None``
                      (exhaustion) at the rate.
``preemption_storm``  cooperative: the engine force-evicts one active
                      slot per tick at the rate.

Determinism: each fault draws from ``np.random.default_rng(seed)`` in
call order, and per-uid poisoning hashes ``(seed, uid)``: the same seed
over the same workload fires the same way.  A draw is made per call —
per eager call here, where the JAX package draws once per traced call —
so kernel faults compare with the JAX package's at rate 1.0 and the
host-side faults (``page_alloc``, ``preemption_storm``) at any rate.
Nothing here touches a production path while no fault is installed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Dict, Iterator, Optional

import numpy as np

KINDS = ("kernel_matmul", "kernel_grouped", "nan_activation",
         "nan_logits", "page_alloc", "preemption_storm")


class FaultInjected(RuntimeError):
    """Raised by an injected kernel fault."""


@dataclasses.dataclass
class Fault:
    """One installed fault: kind + rate + seed (+ optional uid set)."""
    kind: str
    rate: float = 1.0
    seed: int = 0
    uids: Optional[frozenset] = None
    fired: int = 0                      # telemetry: times the fault hit

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def fire(self) -> bool:
        """Sequentially-seeded Bernoulli draw at ``rate``."""
        hit = bool(self._rng.random() < self.rate)
        if hit:
            self.fired += 1
        return hit

    def poisons(self, uid: int) -> bool:
        """Deterministic per-uid poisoning (``nan_logits``): an explicit
        ``uids`` set wins, else hash (seed, uid) against ``rate``."""
        if self.uids is not None:
            return uid in self.uids
        draw = np.random.default_rng([self.seed, int(uid)]).random()
        return bool(draw < self.rate)


_ACTIVE: Dict[str, Fault] = {}


def installed(kind: str) -> bool:
    return kind in _ACTIVE


def spec(kind: str) -> Optional[Fault]:
    """The active fault of this kind, or None (cooperative consumers)."""
    return _ACTIVE.get(kind)


def active() -> list:
    return sorted(_ACTIVE)


# ---------------------------------------------------------------------------
# patch points


def _patch_raising(stack: contextlib.ExitStack, module: str, fns,
                   fault: Fault) -> None:
    """Replace kernel wrappers on their module with raising stubs,
    restored on exit.  A wrapper counts its card launches on its own
    module-level name (``bitmap_spgemm_planned.launches``), so the stub
    carries the count while installed and hands it back on exit."""
    mod = importlib.import_module(module)
    for fn in fns:
        orig = getattr(mod, fn)

        def boom(*a, __orig=orig, __fn=fn, **kw):
            if fault.fire():
                raise FaultInjected(f"injected kernel fault in {__fn}")
            return __orig(*a, **kw)

        boom.launches = orig.launches

        def restore(orig=orig, boom=boom, fn=fn):
            orig.launches = boom.launches
            setattr(mod, fn, orig)

        stack.callback(restore)
        setattr(mod, fn, boom)


def _nanify(out):
    """``out`` (a tensor or a SparseActivation) with element 0 of its
    last axis NaN; the metadata is left as it was."""
    from repro_torch.sparse.activation import SparseActivation
    sparse = isinstance(out, SparseActivation)
    values = (out.values if sparse else out).clone()
    values[..., 0] = float("nan")
    return dataclasses.replace(out, values=values) if sparse else values


def _patch_activation(stack: contextlib.ExitStack, fault: Fault) -> None:
    """NaN element 0 of the sparse path's activation outputs at the
    rate."""
    from repro_torch.sparse import activation as act_mod

    orig = act_mod.activate

    def poisoned(*a, **kw):
        out = orig(*a, **kw)
        return _nanify(out) if fault.fire() else out

    stack.callback(setattr, act_mod, "activate", orig)
    act_mod.activate = poisoned


def _patch_alloc(stack: contextlib.ExitStack, fault: Fault) -> None:
    """PageAllocator.alloc returns None (exhaustion) at the rate."""
    from repro_torch.serving.scheduler import PageAllocator

    orig = PageAllocator.alloc

    def flaky(self, n):
        if fault.fire():
            return None
        return orig(self, n)

    stack.callback(setattr, PageAllocator, "alloc", orig)
    PageAllocator.alloc = flaky


@contextlib.contextmanager
def inject(kind: str, *, rate: float = 1.0, seed: int = 0,
           uids=None) -> Iterator[Fault]:
    """Install one fault for the dynamic extent of the ``with`` block."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; one of {KINDS}")
    if kind in _ACTIVE:
        raise RuntimeError(f"fault {kind!r} is already installed")
    fault = Fault(kind, rate=rate, seed=seed,
                  uids=None if uids is None else frozenset(uids))
    with contextlib.ExitStack() as stack:
        _ACTIVE[kind] = fault
        stack.callback(_ACTIVE.pop, kind, None)
        if kind == "kernel_matmul":
            _patch_raising(stack, "repro_torch.kernels.bitmap_spgemm",
                           ("bitmap_spgemm_planned",
                            "bitmap_spgemm_kfused_planned"), fault)
        elif kind == "kernel_grouped":
            _patch_raising(stack, "repro_torch.kernels.grouped_spgemm",
                           ("grouped_spgemm_planned",
                            "grouped_spgemm_kfused_planned"), fault)
        elif kind == "nan_activation":
            _patch_activation(stack, fault)
        elif kind == "page_alloc":
            _patch_alloc(stack, fault)
        # nan_logits / preemption_storm are cooperative (registry only):
        # the engine reads spec() and owns the degradation path
        yield fault


@contextlib.contextmanager
def chaos(seed: int = 0, *, kernel: bool = True, alloc_rate: float = 0.25,
          storm_rate: float = 0.2, poisoned_uids=()) -> Iterator[dict]:
    """The full seeded fault matrix in one context."""
    with contextlib.ExitStack() as stack:
        installed_faults = {}
        if kernel:
            installed_faults["kernel_matmul"] = stack.enter_context(
                inject("kernel_matmul", seed=seed))
            installed_faults["kernel_grouped"] = stack.enter_context(
                inject("kernel_grouped", seed=seed + 1))
        if alloc_rate > 0:
            installed_faults["page_alloc"] = stack.enter_context(
                inject("page_alloc", rate=alloc_rate, seed=seed + 2))
        if storm_rate > 0:
            installed_faults["preemption_storm"] = stack.enter_context(
                inject("preemption_storm", rate=storm_rate, seed=seed + 3))
        if poisoned_uids:
            installed_faults["nan_logits"] = stack.enter_context(
                inject("nan_logits", uids=poisoned_uids, seed=seed + 4))
        yield installed_faults


# ---------------------------------------------------------------------------
# file corruption helpers (tuning cache robustness)


def corrupt_json(path: str, mode: str = "truncate") -> str:
    """Corrupt an on-disk JSON document in place.

    ``truncate``  chop the document mid-token.
    ``garbage``   replace it with non-JSON text.
    ``binary``    replace it with undecodable bytes.
    """
    if mode == "truncate":
        with open(path) as f:
            doc = f.read()
        with open(path, "w") as f:
            f.write(doc[:max(1, len(doc) // 2)].rstrip("}\n "))
    elif mode == "garbage":
        with open(path, "w") as f:
            f.write("this is { not :: json\n")
    elif mode == "binary":
        with open(path, "wb") as f:
            f.write(b"\x80\x81\xfe\xff spgemm")
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return path
