"""Per-(arch × shape) sparse autotuner with a persistent cache (the JAX
package's ``sparse/autotune.py``).

The tile sizes, slice granularity and condensation mode that win on one
(M, N, K, sparsity) regime lose on another, and the crossover between
the kernels and the dense arm moves with all of them.  This module makes
those knobs a measured, cached decision:

* a **tuning cache** maps a bucketed call-site key —
  ``platform|dtype|op|M/N/K buckets|sparsity bucket[|extra]`` — to the
  winning :class:`Knobs` vector (backend + block_m/block_n/slice_k) and
  its measured time;
* **candidate generation** enumerates the knob lattice, drops what
  :func:`repro_torch.sparse.plan.knobs_valid` rejects and ranks the rest
  with the sparse roofline (:func:`score`);
* **timed sweeps** (:func:`tune_matmul`, :func:`tune_grouped`,
  :func:`tune_attn`) time the survivors against the hand-set baseline
  with one timer, so "tuned <= baseline" holds by construction;
* the **dispatch layer** consults :func:`lookup` per call site
  (:mod:`repro_torch.sparse.site`); a miss or a stale entry falls back
  to the config constants.

Platforms: a key's platform is ``"cpu"`` for CPU tensors, which run the
plain walks, and ``"cuda"`` on the card.  The CPU keeps the JAX
package's interpret-mode rules (block_n in units of 8, a per-step
overhead :data:`INTERPRET_STEP_OVERHEAD_S` in the scorer), so CPU keys,
candidate lists and cache entries are the JAX package's string for
string; the card uses 128-column units and no step overhead.  The card's
timer (:func:`card_timer`) spans the whole dispatch call, the host's
planning included, as the JAX package's wall clock does.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.launch import costmodel, roofline
from repro_torch.sparse import plan as pln

CACHE_VERSION = 1

# Backends the tuner chooses between, in dispatch terms:
#   xla    — use_kernel=False (the dense arm: one torch.matmul)
#   kernel — use_kernel=True, condense=None (K1/K3, slice-granular)
#   kfused — use_kernel=True, condense="k" (K2/K4, element-granular)
# ("xla" keeps the JAX package's name, so caches read across packages.)
BACKENDS = ("xla", "kernel", "kfused")

# Sparsity-bucket bin edges (fraction of zeros); no hint → "any".
SPARSITY_BINS = (0.0, 0.25, 0.5, 0.75, 0.9, 0.99)
ANY = "any"

# Per-executed-step overhead the scorer charges the CPU's plain walks
# (one PyTorch step a schedule position); zero on the card.
INTERPRET_STEP_OVERHEAD_S = 2e-4

_DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
                "int8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1}


def dtype_name(dtype) -> str:
    """``"float32"``/``"bfloat16"``/… for a torch dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(getattr(dtype, "name", dtype))


def platform_of(interpret: bool) -> str:
    """The key's platform: ``"cpu"`` for the plain walks, ``"cuda"`` on
    the card."""
    return "cpu" if interpret else "cuda"


class Knobs(NamedTuple):
    """One tunable dispatch decision: backend + geometry."""
    backend: str
    block_m: int
    block_n: int
    slice_k: int

    def kwargs(self) -> dict:
        """The dispatch kwargs this vector denotes (see BACKENDS)."""
        return dict(block_m=self.block_m, block_n=self.block_n,
                    slice_k=self.slice_k,
                    use_kernel=self.backend != "xla",
                    condense="k" if self.backend == "kfused" else None)

    def valid_for(self, m: int, n: int, k: int, *,
                  interpret: bool = False, dtype_bytes: int = 4,
                  grouped: bool = False) -> bool:
        kw = self.kwargs()
        return self.backend in BACKENDS and pln.knobs_valid(
            m, n, k, self.block_m, self.block_n, self.slice_k,
            use_kernel=kw["use_kernel"], condense=kw["condense"],
            interpret=interpret, dtype_bytes=dtype_bytes, grouped=grouped)


def knobs_from_config(cfg) -> Knobs:
    """The hand-set config constants as a Knobs vector (the fallback
    tier, and the sweep baseline)."""
    if cfg.sparse_use_kernel:
        backend = "kfused" if cfg.sparse_kcondense else "kernel"
    else:
        backend = "xla"
    return Knobs(backend=backend, block_m=cfg.sparse_block_m,
                 block_n=cfg.sparse_block_n, slice_k=cfg.sparse_slice_k)


def clamp_knobs(kn: Knobs, m: int, n: int, k: int,
                interpret: bool) -> Knobs:
    """Clamp a knob vector to a problem: the effective hand-set config at
    small shapes.  On the CPU as the dispatch clamps
    (:func:`repro_torch.sparse.plan.clamp_geometry`, the JAX package's
    interpret-mode clamp); on the card to each dimension rounded up to
    its unit (8 rows, 128 columns, 8 positions), as :func:`lattice`
    clamps, so the clamped vector stays one ``knobs_valid`` admits — the
    dispatch shrinks it to the problem when it runs."""
    if interpret:
        bm, bn, sk = pln.clamp_geometry(m, n, k, kn.block_m, kn.block_n,
                                        kn.slice_k)
    else:
        bm = min(kn.block_m, pln._round_up(m, pln.SUBLANE))
        bn = min(kn.block_n, pln._round_up(n, pln.LANE))
        sk = min(kn.slice_k, pln._round_up(k, pln.SUBLANE))
    return Knobs(kn.backend, bm, bn, sk)


# ---------------------------------------------------------------------------
# cache keys
# ---------------------------------------------------------------------------

def bucket_dim(x: int) -> int:
    """Next power of two >= x (shape bucket)."""
    x = max(int(x), 1)
    b = 1
    while b < x:
        b <<= 1
    return b


def bucket_sparsity(sparsity: Optional[float]) -> str:
    """Nearest bin label for a zero-fraction hint; None → 'any'."""
    if sparsity is None or sparsity < 0:
        return ANY
    s = min(max(float(sparsity), 0.0), 1.0)
    best = min(SPARSITY_BINS, key=lambda b: abs(b - s))
    return f"{best:g}"


def make_key(op: str, m: int, n: int, k: int, *, dtype,
             sparsity: Optional[float] = None,
             platform: Optional[str] = None, extra: str = "") -> str:
    """The persistent cache key for one bucketed call site.

    ``op`` separates the namespaces (``matmul``, ``grouped``, ``conv``,
    ``attn.score``, ``attn.value``; the grouped ones add the
    problem-count bucket as ``extra``); M buckets keep decode (M = batch)
    and prefill (M = tokens) apart.  ``platform`` defaults to ``"cuda"``
    where a card is present, else ``"cpu"``.
    """
    if platform is None:
        platform = platform_of(not torch.cuda.is_available())
    key = (f"{platform}|{dtype_name(dtype)}|{op}|m{bucket_dim(m)}"
           f"|n{bucket_dim(n)}|k{bucket_dim(k)}|s{bucket_sparsity(sparsity)}")
    if extra:
        key += f"|{extra}"
    return key


# ---------------------------------------------------------------------------
# the persistent cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TuningCache:
    """key → winning knob vector + its measurement (JSON-persistable).

    Entry schema (the JAX package's on-disk format)::

        {"backend": "xla|kernel|kfused", "block_m": int, "block_n": int,
         "slice_k": int, "us": float, "baseline_us": float,
         "source": "tuned"}
    """
    entries: Dict[str, dict] = dataclasses.field(default_factory=dict)
    path: Optional[str] = None

    def get(self, key: str) -> Optional[Knobs]:
        e = self.entries.get(key)
        if e is None:
            return None
        return Knobs(backend=e["backend"], block_m=int(e["block_m"]),
                     block_n=int(e["block_n"]), slice_k=int(e["slice_k"]))

    def put(self, key: str, kn: Knobs, us: float,
            baseline_us: Optional[float] = None) -> None:
        self.entries[key] = {
            "backend": kn.backend, "block_m": kn.block_m,
            "block_n": kn.block_n, "slice_k": kn.slice_k,
            "us": float(us),
            "baseline_us": None if baseline_us is None
            else float(baseline_us),
            "source": "tuned"}

    def save(self, path: Optional[str] = None) -> str:
        """Atomic persist: write a sibling temp file, then rename — a
        killed sweep can truncate the temp, never the cache."""
        path = path or self.path
        if not path:
            raise ValueError("TuningCache.save: no path")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": self.entries},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        self.path = path
        return path

    def load(self, path: str, merge: bool = True) -> "TuningCache":
        """Merge a persisted cache.

        Truncated or corrupt JSON degrades to an empty document with a
        warn-once (a damaged cache must not take the process down: every
        lookup falls back to the config constants).  A *valid* document
        of a foreign schema version raises: that is a mismatch, not
        damage.
        """
        from repro_torch.sparse.dispatch import warn_once
        try:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise json.JSONDecodeError(
                    "top-level document is not an object", "", 0)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            warn_once(f"tunecache-corrupt:{path}",
                      f"tuning cache {path} is truncated or corrupt "
                      f"({e}); continuing with an empty cache "
                      "(dispatch falls back to config constants)")
            doc = {"version": CACHE_VERSION, "entries": {}}
        if doc.get("version") != CACHE_VERSION:
            raise ValueError(
                f"tuning cache {path}: version {doc.get('version')!r} "
                f"!= {CACHE_VERSION}")
        entries = doc.get("entries", {})
        if not isinstance(entries, dict):
            warn_once(f"tunecache-corrupt:{path}",
                      f"tuning cache {path}: 'entries' is not an "
                      "object; ignoring it")
            entries = {}
        if not merge:
            self.entries.clear()
        self.entries.update(entries)
        self.path = path
        return self


# process-global cache + telemetry (tests reset via reset())
_CACHE = TuningCache()
HITS = 0
MISSES = 0
STALE = 0
# every dispatch lookup, hit or miss: key → {op, m, n, k, dtype,
# sparsity, extra, count}.  The key-discovery surface.
OBSERVED: Dict[str, dict] = {}


def get_cache() -> TuningCache:
    return _CACHE


def load_cache(path: str, merge: bool = True) -> TuningCache:
    """Load (by default merge) a persisted cache into the process-global
    one the dispatch layer consults."""
    return _CACHE.load(path, merge=merge)


def save_cache(path: str) -> str:
    return _CACHE.save(path)


def reset() -> None:
    """Clear the global cache and telemetry (test isolation)."""
    global HITS, MISSES, STALE
    _CACHE.entries.clear()
    _CACHE.path = None
    HITS = MISSES = STALE = 0
    OBSERVED.clear()


def lookup(op: str, m: int, n: int, k: int, *, dtype,
           sparsity: Optional[float] = None, interpret: bool = False,
           extra: str = "") -> Optional[Knobs]:
    """Consult the cache for one call site; None ⇒ fall back to config.

    Tries the exact sparsity bucket, then the 'any' bucket.  A hit is
    re-validated against :func:`repro_torch.sparse.plan.knobs_valid` for
    the *actual* (m, n, k): buckets are ranges, and a stale or
    foreign-shape entry must fall back, never reach a kernel.  Records
    the observation either way.
    """
    global HITS, MISSES, STALE
    dt = dtype_name(dtype)
    plat = platform_of(interpret)
    key = make_key(op, m, n, k, dtype=dt, sparsity=sparsity,
                   platform=plat, extra=extra)
    obs = OBSERVED.setdefault(key, {
        "op": op, "m": int(m), "n": int(n), "k": int(k), "dtype": dt,
        "sparsity": None if sparsity is None else float(sparsity),
        "extra": extra, "count": 0})
    obs["count"] += 1
    tried = [key]
    if bucket_sparsity(sparsity) != ANY:
        tried.append(make_key(op, m, n, k, dtype=dt, sparsity=None,
                              platform=plat, extra=extra))
    for key_i in tried:
        kn = _CACHE.get(key_i)
        if kn is None:
            continue
        if kn.valid_for(m, n, k, interpret=interpret,
                        dtype_bytes=_DTYPE_BYTES.get(dt, 4),
                        grouped=bool(extra)):
            HITS += 1
            return kn
        STALE += 1
    MISSES += 1
    return None


def record(op: str, m: int, n: int, k: int, *, dtype, sparsity,
           knobs: Knobs, us: float, baseline_us: Optional[float] = None,
           extra: str = "", also_any: bool = True,
           cache: Optional[TuningCache] = None,
           platform: Optional[str] = None) -> str:
    """Store a sweep winner under its bucketed key.

    ``also_any`` mirrors the entry into the 'any' sparsity bucket when it
    is empty or slower, so call sites without a sparsity hint (the
    default model path) still hit.
    """
    cache = cache or _CACHE
    key = make_key(op, m, n, k, dtype=dtype, sparsity=sparsity,
                   platform=platform, extra=extra)
    cache.put(key, knobs, us, baseline_us)
    if also_any and bucket_sparsity(sparsity) != ANY:
        any_key = make_key(op, m, n, k, dtype=dtype, sparsity=None,
                           platform=platform, extra=extra)
        prev = cache.entries.get(any_key)
        if prev is None or float(prev.get("us", float("inf"))) > us:
            cache.put(any_key, knobs, us, baseline_us)
    return key


# ---------------------------------------------------------------------------
# candidate generation + cost-model pruning
# ---------------------------------------------------------------------------

_BLOCK_M_CHOICES = (8, 16, 32, 64, 128, 256)
_BLOCK_N_CHOICES = (128, 256, 512)
_BLOCK_N_INTERP = (8, 32, 128, 256)
_SLICE_K_CHOICES = (32, 64, 128, 256)


def score(kn: Knobs, m: int, n: int, k: int, *,
          a_density: float = 1.0, w_density: float = 1.0,
          dtype_bytes: int = 4, interpret: bool = False,
          n_groups: int = 1) -> float:
    """Predicted seconds for one candidate (lower is better)."""
    kw = kn.kwargs()
    frac = costmodel.sparse_step_fraction(
        kn.block_m, kn.block_n, kn.slice_k, k, a_density=a_density,
        w_density=w_density, condense=kw["condense"])
    terms = roofline.sparse_matmul(
        m, n, k, executed_fraction=frac, block_m=kn.block_m,
        block_n=kn.block_n, dtype_bytes=dtype_bytes, backend=kn.backend,
        step_overhead_s=INTERPRET_STEP_OVERHEAD_S if interpret else 0.0)
    return terms["predict_s"] * max(n_groups, 1)


def lattice(m: int, n: int, k: int, *, interpret: bool = False
            ) -> Tuple[List[int], List[int], List[int]]:
    """The (block_m, block_n, slice_k) choices for an (m, n, k) problem,
    clamped as :func:`repro_torch.sparse.plan.clamp_geometry` would — for
    small dims every unclamped choice can overshoot the round-up bound,
    and a sweep must never come back empty."""
    lane = pln.CPU_LANE if interpret else pln.LANE
    bm = sorted({min(b, pln._round_up(m, 8)) for b in _BLOCK_M_CHOICES})
    bn = sorted({min(b, pln._round_up(n, lane)) for b in
                 (_BLOCK_N_INTERP if interpret else _BLOCK_N_CHOICES)})
    sk = sorted({min(s, pln._round_up(k, 8)) for s in _SLICE_K_CHOICES})
    return bm, bn, sk


def candidates(m: int, n: int, k: int, *, a_sparsity: float = 0.0,
               w_sparsity: float = 0.0, dtype_bytes: int = 4,
               interpret: bool = False, n_groups: int = 1,
               max_candidates: int = 8,
               include: Tuple[Knobs, ...] = ()) -> List[Knobs]:
    """Valid knob vectors for an (m, n, k) problem, cost-model ranked.

    Enumerates backend × :func:`lattice`, drops what
    :func:`repro_torch.sparse.plan.knobs_valid` rejects (``n_groups > 1``
    checks K3/K4's routes), scores the rest with the sparse roofline and
    keeps the ``max_candidates`` best — always keeping one ``xla``
    candidate (the crossover must stay measurable) and everything in
    ``include`` (the sweep baseline).
    """
    a_d = 1.0 - min(max(a_sparsity, 0.0), 1.0)
    w_d = 1.0 - min(max(w_sparsity, 0.0), 1.0)
    grouped = n_groups > 1
    bm_choices, bn_choices, sk_choices = lattice(m, n, k,
                                                 interpret=interpret)

    def valid(kn):
        return kn.valid_for(m, n, k, interpret=interpret,
                            dtype_bytes=dtype_bytes, grouped=grouped)

    pool: List[Knobs] = []
    for backend in BACKENDS:
        for bm in bm_choices:
            for bn in bn_choices:
                for sk in sk_choices:
                    kn = Knobs(backend, bm, bn, sk)
                    if valid(kn):
                        pool.append(kn)
        if backend == "xla" and pool:
            # geometry changes only the dense arm's accounting, not its
            # compute: one representative is enough
            pool = [max(pool, key=lambda c: (c.block_m, c.block_n,
                                             c.slice_k))]
    ranked = sorted(pool, key=lambda c: score(
        c, m, n, k, a_density=a_d, w_density=w_d, dtype_bytes=dtype_bytes,
        interpret=interpret, n_groups=n_groups))
    out: List[Knobs] = [kn for kn in include if valid(kn)]
    for kn in ranked:
        if len(out) >= max_candidates + len(include):
            break
        if kn not in out:
            out.append(kn)
    if not any(c.backend == "xla" for c in out):
        xla = [c for c in ranked if c.backend == "xla"]
        if xla:
            out.append(xla[0])
    return out


# ---------------------------------------------------------------------------
# timed sweeps
# ---------------------------------------------------------------------------

def _default_timer(fn: Callable[[], None], warmup: int = 1,
                   repeat: int = 3) -> float:
    """Median wall-clock µs of fn() (first runs excluded by warmup)."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e6)
    ts.sort()
    return ts[len(ts) // 2]


def card_timer(fn: Callable[[], None], warmup: int = 1,
               repeat: int = 3) -> float:
    """Median µs of fn() on the card: a CUDA event pair on the current
    stream around the whole call, recorded after a synchronize.  The
    stream is idle when the first event is recorded, so the span starts
    at the call's start and covers the host's planning as well as the
    launches — the JAX package's wall clock around ``fn()``, not a
    device-only time (planning changes with block_m/slice_k)."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) * 1e3)
    ts.sort()
    return ts[len(ts) // 2]


def _timer_for(interp: bool, timer: Optional[Callable]) -> Callable:
    return timer or (_default_timer if interp else card_timer)


def _sweep(run: Callable[[Knobs], Callable[[], None]],
           cands: List[Knobs], baseline: Knobs,
           timer: Optional[Callable] = None) -> Tuple[Knobs, float, float,
                                                      List[dict]]:
    """Time baseline + candidates with one timer; argmin wins.

    The baseline is timed in the same sweep, so the winner is <= the
    hand-set config by construction.
    """
    timer = timer or _default_timer
    rows: List[dict] = []
    best: Optional[Knobs] = None
    best_us = float("inf")
    baseline_us = float("inf")
    seen = []
    for kn in [baseline] + [c for c in cands if c != baseline]:
        if kn in seen:
            continue
        seen.append(kn)
        us = float(timer(run(kn)))
        rows.append({"backend": kn.backend, "block_m": kn.block_m,
                     "block_n": kn.block_n, "slice_k": kn.slice_k,
                     "us": us, "is_baseline": kn == baseline})
        if kn == baseline:
            baseline_us = us
        if us < best_us:
            best, best_us = kn, us
    return best, best_us, baseline_us, rows


def _summary(key, op, m, n, k, dt, sparsity, baseline, baseline_us, best,
             best_us, rows, e=None) -> dict:
    out = {"key": key, "op": op, "m": m, "n": n, "k": k}
    if e is not None:
        out["e"] = e
    out.update({
        "dtype": dt, "sparsity": sparsity,
        "baseline": {"backend": baseline.backend,
                     "block_m": baseline.block_m,
                     "block_n": baseline.block_n,
                     "slice_k": baseline.slice_k, "us": baseline_us},
        "tuned": {"backend": best.backend, "block_m": best.block_m,
                  "block_n": best.block_n, "slice_k": best.slice_k,
                  "us": best_us},
        "speedup": baseline_us / best_us if best_us else 0.0,
        "sweep": rows})
    return out


def tune_matmul(x, w, *, mode: str = "dual",
                sparsity: Optional[float] = None,
                w_sparsity: float = 0.0, baseline: Optional[Knobs] = None,
                timer: Optional[Callable] = None, max_candidates: int = 8,
                out_dtype=None, cache: Optional[TuningCache] = None,
                include: Tuple[Knobs, ...] = ()) -> dict:
    """Sweep one 2-D dispatch call site and cache the winner.

    ``x``/``w`` are what :func:`repro_torch.sparse.dispatch.matmul` takes
    (tensors, SparseActivation, PlannedWeight), on the CPU (its rules) or
    the card.  ``sparsity`` is the activation-side zero fraction the key
    buckets under (and the cost model prunes with); ``baseline`` defaults
    to the repo's constants (kernel, 128, 128, 128), clamped as
    :func:`clamp_knobs` does; ``include`` adds vectors the cost model did
    not rank high enough (a backend's twin of its pick) to the same
    sweep.  The timer defaults to :func:`card_timer` on the card.
    Returns a JSON-ready summary (key, baseline/tuned µs, the whole
    sweep).
    """
    from repro_torch.sparse import dispatch as dsp
    xv, w_arr = dsp._values(x), dsp._weight_array(w)
    k = xv.shape[-1]
    m = xv.shape[:-1].numel()
    n = w_arr.shape[-1]
    interp = dsp._cpu_rules(xv.device)
    dt = dtype_name(xv.dtype)
    if baseline is None:
        baseline = Knobs("kernel", 128, 128, pln.SLICE_K)
    baseline = clamp_knobs(baseline, m, n, k, interp)
    cands = candidates(
        m, n, k, a_sparsity=sparsity or 0.0, w_sparsity=w_sparsity,
        dtype_bytes=_DTYPE_BYTES.get(dt, 4), interpret=interp,
        max_candidates=max_candidates,
        include=(baseline, *(clamp_knobs(c, m, n, k, interp)
                             for c in include)))

    def run(kn: Knobs) -> Callable[[], None]:
        kw = kn.kwargs()

        def fn():
            dsp.matmul(x, w, mode=mode, out_dtype=out_dtype, **kw)
        return fn

    best, best_us, baseline_us, rows = _sweep(run, cands, baseline,
                                              _timer_for(interp, timer))
    key = record("matmul", m, n, k, dtype=dt, sparsity=sparsity,
                 knobs=best, us=best_us, baseline_us=baseline_us,
                 cache=cache, platform=platform_of(interp))
    return _summary(key, "matmul", m, n, k, dt, sparsity, baseline,
                    baseline_us, best, best_us, rows)


def tune_grouped(x, w, *, mode: str = "dual",
                 sparsity: Optional[float] = None, w_sparsity: float = 0.0,
                 baseline: Optional[Knobs] = None,
                 timer: Optional[Callable] = None,
                 max_candidates: int = 8, out_dtype=None,
                 cache: Optional[TuningCache] = None) -> dict:
    """Grouped (stacked-problem) analogue of :func:`tune_matmul`."""
    from repro_torch.sparse import dispatch as dsp
    xv, w_arr = dsp._values(x), dsp._weight_array(w)
    e, c, k = xv.shape
    n = w_arr.shape[-1]
    interp = dsp._cpu_rules(xv.device)
    dt = dtype_name(xv.dtype)
    extra = f"e{bucket_dim(e)}"
    if baseline is None:
        baseline = Knobs("kernel", 128, 128, pln.SLICE_K)
    baseline = clamp_knobs(baseline, c, n, k, interp)
    cands = candidates(
        c, n, k, a_sparsity=sparsity or 0.0, w_sparsity=w_sparsity,
        dtype_bytes=_DTYPE_BYTES.get(dt, 4), interpret=interp,
        n_groups=e, max_candidates=max_candidates, include=(baseline,))

    def run(kn: Knobs) -> Callable[[], None]:
        kw = kn.kwargs()

        def fn():
            dsp.grouped_matmul(x, w, mode=mode, out_dtype=out_dtype, **kw)
        return fn

    best, best_us, baseline_us, rows = _sweep(run, cands, baseline,
                                              _timer_for(interp, timer))
    key = record("grouped", c, n, k, dtype=dt, sparsity=sparsity,
                 knobs=best, us=best_us, baseline_us=baseline_us,
                 extra=extra, cache=cache, platform=platform_of(interp))
    return _summary(key, "grouped", c, n, k, dt, sparsity, baseline,
                    baseline_us, best, best_us, rows, e=e)


# The occupancy-block granularities the attention sweep always times —
# the tuned replacement for the hand-set ``ModelConfig.sparse_block_t``.
_BLOCK_T_CHOICES = (8, 16, 32, 64, 128)


def _attn_operands(cfg, *, batch: int, capacity: int, fill: int,
                   seed: int, dtype, device):
    """Synthetic batched-decode operands, shaped like ``attend_sparse``'s
    (E = batch × kv_heads stacked problems), drawn from a
    ``torch.Generator`` seeded with ``seed`` on the CPU.

    Slots beyond ``fill`` are zero in K/V and in the probabilities, as on
    the real decode path (unwritten cache slots, softmax-masked rows), so
    the sweep's sparsity is what the kernels see.  The value's
    probabilities are float32 against a ``dtype`` V, as ``attend_sparse``
    computes them.
    """
    kvh = cfg.n_kv_heads
    hd = cfg.hd
    g = max(cfg.n_heads // kvh, 1)
    t = capacity
    ne = batch * kvh
    gen = torch.Generator().manual_seed(seed)
    occ = torch.arange(t) < fill
    occ_e = occ[None, :].expand(ne, t).contiguous()

    def draw(*shape, uniform=False):
        x = (torch.rand(*shape, generator=gen) if uniform
             else torch.randn(*shape, generator=gen))
        return x

    kd_e = torch.where(occ[None, :, None], draw(ne, t, hd), 0.0).to(dtype)
    vd_e = torch.where(occ[None, :, None], draw(ne, t, hd), 0.0).to(dtype)
    qw = draw(ne, hd, g).to(dtype)
    p_e = torch.where(occ_e[:, None, :], draw(ne, g, t, uniform=True), 0.0)
    on = dict(device=device)
    return dict(t=t, g=g, hd=hd, ne=ne, occ_e=occ_e.to(**on),
                sched_e=occ_e.to(**on), kd_e=kd_e.to(**on),
                vd_e=vd_e.to(**on), qw=qw.to(**on), p_e=p_e.to(**on))


def tune_attn(cfg, *, batch: int = 1, capacity: int = 64,
              fill: Optional[int] = None, sparsity: Optional[float] = None,
              device=None,
              timer: Optional[Callable] = None, max_candidates: int = 6,
              cache: Optional[TuningCache] = None, seed: int = 0,
              dtype=None, also: Tuple[str, ...] = ()) -> List[dict]:
    """Sweep the decode attention's two grouped matmuls; cache winners.

    The sites are keyed on their matmul geometry:

    * ``attn.score`` — ``scores[e] = K[e] @ q[e]``: (m, n, k) =
      (capacity, group, head_dim), E = batch × kv_heads.  The tuned
      ``block_m`` *is* the score's occupancy tile, so the hand-set
      ``ModelConfig.sparse_block_t`` is this key's baseline.
    * ``attn.value`` — ``out[e] = p[e] @ V[e]``: (m, n, k) =
      (group, head_dim, capacity).  The tuned ``slice_k`` is the value's
      block_t; (p, V) are rebuilt per candidate because the occupancy
      metadata's granularity must follow it.

    ``fill`` is the occupied prefix of the cache (default capacity/2);
    the sparsity hint defaults to the empty-slot fraction.  ``dtype``
    defaults to bfloat16, the decode activation dtype.  ``device``
    (None: the card) holds the operands and picks the rules.  ``also``
    names backends whose twins of the block_t
    variants are swept too (``("kfused",)`` times K4 beside K3).  Returns
    two JSON-ready rows shaped like :func:`tune_grouped`'s.
    """
    from repro_torch.core import device as devmod
    from repro_torch.sparse import dispatch as dsp
    from repro_torch.sparse import kvcache as skvc
    dev = devmod.resolve(device)
    interp = dsp._cpu_rules(dev)
    timer = _timer_for(interp, timer)
    plat = platform_of(interp)
    mode = cfg.sparse_mode if cfg.sparse_mode != "dense" else "dual"
    fill = capacity // 2 if fill is None else fill
    fill = min(max(int(fill), 1), capacity)
    dt = dtype or torch.bfloat16
    ops = _attn_operands(cfg, batch=batch, capacity=capacity, fill=fill,
                         seed=seed, dtype=dt, device=dev)
    t, g, hd, ne = ops["t"], ops["g"], ops["hd"], ops["ne"]
    if sparsity is None:
        sparsity = 1.0 - fill / t
    base = knobs_from_config(cfg)
    extra = f"e{bucket_dim(ne)}"
    dtn = dtype_name(dt)
    dtb = _DTYPE_BYTES.get(dtn, 4)
    rows: List[dict] = []

    def _include(m, n, k, mk):
        """Baseline-backend variants over the block_t lattice (dedup'd,
        baseline first), then those of the ``also`` backends: the
        granularities the hand-set knob chooses between are all in the
        sweep."""
        out = [mk(base.backend, cfg.sparse_block_t)]
        for backend in (base.backend, *also):
            for bt in _BLOCK_T_CHOICES:
                kn = mk(backend, bt)
                if kn not in out:
                    out.append(kn)
        return [clamp_knobs(kn, m, n, k, interp) for kn in out]

    def _row(op, m, n, k, baseline, baseline_us, best, best_us, sweep):
        key = record(op, m, n, k, dtype=dtn, sparsity=sparsity, knobs=best,
                     us=best_us, baseline_us=baseline_us, extra=extra,
                     cache=cache, platform=plat)
        return _summary(key, op, m, n, k, dtn, sparsity, baseline,
                        baseline_us, best, best_us, sweep, e=ne)

    # --- attn.score: block_m is the score tile over cache slots -------
    inc_s = _include(t, g, hd,
                     lambda be, bt: Knobs(be, bt, base.block_n,
                                          base.slice_k))
    cands_s = candidates(t, g, hd, a_sparsity=sparsity, dtype_bytes=dtb,
                         interpret=interp, n_groups=ne,
                         max_candidates=max_candidates,
                         include=tuple(inc_s))

    def run_score(kn: Knobs) -> Callable[[], None]:
        kw = kn.kwargs()
        sk = pln.effective_slice_k(hd, kw["slice_k"])
        x_k = skvc.score_operand(ops["kd_e"], ops["sched_e"], sk)

        def fn():
            dsp.grouped_matmul(x_k, ops["qw"], mode=mode,
                               out_dtype=torch.float32,
                               **{**kw, "slice_k": sk})
        return fn

    best, best_us, baseline_us, sweep = _sweep(run_score, cands_s,
                                               inc_s[0], timer)
    rows.append(_row("attn.score", t, g, hd, inc_s[0], baseline_us,
                     best, best_us, sweep))

    # --- attn.value: slice_k is the value-side occupancy block_t ------
    inc_v = _include(g, hd, t,
                     lambda be, bt: Knobs(be, base.block_m, base.block_n,
                                          bt))
    cands_v = candidates(g, hd, t, a_sparsity=sparsity, dtype_bytes=dtb,
                         interpret=interp, n_groups=ne,
                         max_candidates=max_candidates,
                         include=tuple(inc_v))

    def run_value(kn: Knobs) -> Callable[[], None]:
        kw = kn.kwargs()
        bt = pln.effective_slice_k(t, kw["slice_k"])
        x_p, w_v = skvc.value_operands(ops["occ_e"], ops["p_e"],
                                       ops["vd_e"], ops["sched_e"], bt)

        def fn():
            dsp.grouped_matmul(x_p, w_v, mode=mode,
                               out_dtype=torch.float32,
                               **{**kw, "slice_k": bt})
        return fn

    best, best_us, baseline_us, sweep = _sweep(run_value, cands_v,
                                               inc_v[0], timer)
    rows.append(_row("attn.value", g, hd, t, inc_v[0], baseline_us,
                     best, best_us, sweep))
    return rows


def default_cache_path(root: Optional[str] = None) -> str:
    """Where sweeps persist the port's cache by default:
    ``build/repro_torch/autotune_cache.json`` under ``root`` (default:
    the checkout this package lies in), beside the kernels' builds — not
    the repository root's ``BENCH_autotune_cache.json``, which is the JAX
    package's."""
    base = Path(root) if root else Path(__file__).resolve().parents[3]
    path = base / "build" / "repro_torch" / "autotune_cache.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    return str(path)
