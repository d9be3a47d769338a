"""Continuous-batching serving engine (paged, batched, vLLM-lite).

The JAX package's ``serving/engine.py``: a host-side control plane around
three cores, which here are plain methods run under
``torch.inference_mode()`` (the JAX engine jits them):

* **prefill** — admitted requests pack into shape-bucketed batches, each
  one prefill into fresh contiguous full-history caches;
* **insert** — each prefilled row is copied into the shared
  :class:`~repro_torch.sparse.kvcache.PagedSparseKVCache` page pools at
  the physical pages the host allocator backed for its slot, and a Mamba
  layer's row of :class:`~repro_torch.models.ssm.SSMState` into its
  slot's state;
* **decode** — ONE step per engine tick advances every slot together:
  tokens (B, 1), per-slot positions (B, 1); in a sparse mode both
  attention products go through the grouped dispatch as one E = B·KV
  problem set spanning the slots, each slot with its own schedule.  A
  Mamba layer steps every slot's recurrent state, idle slots' too (as
  the JAX engine does); an insert overwrites the slot's state.

The prefill and decode cores each end in one host read (the next tokens
and the per-row ``ok`` flags), as ``np.asarray`` does in the JAX engine.  Slots share one
physical pool per layer; pages freed by retired (or preempted) requests
recycle across requests through :class:`PageAllocator`, and per-page
occupancy doubles as the decode schedule's block bitmap.  Admission order
and preemption victims come from
:class:`repro_torch.serving.scheduler.Scheduler`: under the ``cost``
policy a request's cost is the StepCounts tape of one prefill (scheduled
steps).

A request whose step produces non-finite logits retires with
``status="error"`` without perturbing its batch siblings (rows are
independent through attention, MLP and head); page-allocation failures
self-preempt with bounded exponential backoff instead of crashing
admission; ``run_to_completion`` watches for progress and raises
:class:`EngineStalled` with an :meth:`Engine.health` snapshot and the
unfinished requests rather than dropping in-flight work.

Guards: with ``RunConfig.validate`` (or ``REPRO_VALIDATE=1``) every
tick ends in :meth:`Engine.validate_state` (allocator, page ownership,
the pools' occupancy, :mod:`repro_torch.sparse.validate`); under
:mod:`repro_torch.testing.faults` the ``nan_logits`` fault (read at
construction) poisons the decode logits of its request uids and
``preemption_storm`` evicts a slot after a tick's admissions.
:meth:`Engine.autotune_keys` lists the tuning-cache keys the engine's
forwards consult, and with ``cfg.sparse_autotune`` the engine loads
``cfg.sparse_tune_cache`` at construction; :meth:`Engine.health` reports
the sites' quarantines and the cache's hits and misses.

The JAX engine's legacy per-slot control plane
(``_admit_legacy``, ``_step_legacy``, ``_decode_one``), which the JAX
package meant for encoder-decoder and cross-attention stacks, is not
ported: its ``Request`` carries no mel frames or images, and its prefill
calls ``forward`` with the tokens alone, so it raises ``KeyError`` for
every config that reaches it.  Such a config (whisper, the VLM) raises
``ValueError`` here at construction, from ``init_paged_caches``.
With ``rc.kv_quant`` the page pools and the prefill caches are int8.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ServeConfig
from repro_torch.core import device as devmod
from repro_torch.models import ssm as ssmm
from repro_torch.models import transformer as tfm
from repro_torch.serving.scheduler import (PageAllocator, Scheduler,
                                           pack_prefills)
from repro_torch.sparse import autotune as atn
from repro_torch.sparse import dispatch as dsp
from repro_torch.sparse import kvcache as skvc
from repro_torch.sparse import plan as pln
from repro_torch.sparse import site as ssite
from repro_torch.sparse import tape
from repro_torch.sparse import validate as val
from repro_torch.testing import faults


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # lifecycle: queued → active → done | error (terminal; ``error``
    # holds the reason: "nonfinite_logits" | "deadline")
    status: str = "queued"
    error: Optional[str] = None
    # optional wall budget in engine ticks from submission; exceeded →
    # terminal error retirement (queued or active alike)
    deadline_ticks: Optional[int] = None
    # recompute-preemption resume point: prompt + output at eviction time
    # (the user-visible ``prompt`` is never mutated)
    resume_prompt: Optional[List[int]] = dataclasses.field(
        default=None, repr=False)
    # robustness bookkeeping
    submit_tick: int = dataclasses.field(default=0, repr=False)
    not_before: int = dataclasses.field(default=0, repr=False)
    preempt_retries: int = dataclasses.field(default=0, repr=False)


class EngineStalled(RuntimeError):
    """``run_to_completion`` gave up: no progress within the watchdog
    window, or the tick budget ran out with work still in flight.

    ``health`` is the :meth:`Engine.health` snapshot at raise time and
    ``unfinished`` the queued and active requests that did not complete.
    """

    def __init__(self, message: str, health: dict, unfinished):
        super().__init__(message)
        self.health = health
        self.unfinished = list(unfinished)


def _round_up(x: int, unit: int) -> int:
    return -(-x // unit) * unit


class Engine:
    """The paged continuous-batching engine over one model.

    ``device=None`` means the card (and raises without one); the model
    must already live on the device.  :meth:`stats` has every key of the
    JAX engine's but the ``*_traces`` compile counters, which have no
    meaning without a jit.
    """

    def __init__(self, model: tfm.Transformer, cfg: ModelConfig, *,
                 slots: int = 4, capacity: int = 256,
                 rc: Optional[RunConfig] = None, eos_id: int = -1,
                 serve: Optional[ServeConfig] = None,
                 scheduler: Optional[Scheduler] = None, device=None):
        self.dev = devmod.resolve(device)
        devmod.check_on(model.embed, self.dev, "the model")
        if serve is None:
            serve = ServeConfig(slots=slots, capacity=capacity,
                                eos_id=eos_id)
        self.model = model
        self.cfg = cfg
        self.rc = rc
        self.serve = serve
        self.slots = serve.slots
        self.capacity = serve.capacity      # retire bound (user-visible)
        self.eos_id = serve.eos_id
        self.quantized = bool(rc and rc.kv_quant)

        # page geometry: page size == the sparse planner's block_t, so a
        # page's occupied count is the schedule's block entry
        self.page = serve.page_size or cfg.sparse_block_t
        self.cap_pages = _round_up(self.capacity, self.page)
        self.n_blocks = self.cap_pages // self.page
        self.n_pages = serve.pages or self.slots * self.n_blocks
        kinds = [cfg.layer_kind(p) for p in range(cfg.period)]
        # exact-length, unpacked prefill where padding or co-batching
        # perturbs per-request numerics: MoE expert capacity scales with
        # the token count, SSM recurrent state integrates padded steps
        self._exact_prefill = (getattr(cfg, "n_experts", 0) > 0
                               or "mamba" in kinds)
        self.bucket = 1 if self._exact_prefill else (
            serve.prefill_bucket or self.page)

        # per-request accounting
        self.active: Dict[int, Optional[Request]] = {
            i: None for i in range(self.slots)}
        self.pos = [0] * self.slots
        self.last_tok = np.zeros((self.slots,), np.int64)
        self.pages_held: Dict[int, List[int]] = {}
        self.admitted_tick: Dict[int, int] = {}
        self._early: List[Request] = []
        self.allocator = PageAllocator(self.n_pages)
        if scheduler is None:
            cost_fn = (self._request_cost
                       if serve.policy == "cost" else None)
            scheduler = Scheduler(serve.policy, cost_fn=cost_fn)
        self.scheduler = scheduler

        # control-plane counters
        self.ticks = 0
        self.evictions = 0
        self.prefill_calls = 0
        self.decode_calls = 0
        self.tokens_emitted = 0        # progress signal for the watchdog
        self.errored = 0               # terminal error retirements

        # robustness: the invariant validators each tick under
        # RunConfig.validate (or REPRO_VALIDATE=1); the nan_logits fault
        # is read once here, as the JAX engine binds it to its decode
        self._validate = bool(rc and getattr(rc, "validate", False))
        self._logit_fault = faults.spec("nan_logits")

        # static weight-side sparse plans: built once per engine (weights
        # don't change at inference), reused by every prefill and decode
        self.weight_plans = tfm.plan_weight_activities(model, cfg)
        # the persisted tuning cache, loaded before the first forward
        if cfg.sparse_autotune and cfg.sparse_tune_cache:
            atn.load_cache(cfg.sparse_tune_cache)

        with torch.inference_mode():
            self.caches = tfm.init_paged_caches(
                cfg, self.slots, self.n_pages, self.page, self.cap_pages,
                quantized=self.quantized, device=self.dev)
        self.table_host = np.zeros((self.slots, self.n_blocks), np.int32)
        self._table_dirty = False

    # -- cores -------------------------------------------------------
    # Every core returns a per-row ``ok = all(isfinite(logits))`` flag
    # beside the greedy tokens: a request whose row goes non-finite
    # retires with status="error" on the host, its siblings untouched.

    def _greedy(self, logits: torch.Tensor):
        """(next tokens, ok) of (B, V) logits, read to the host at once."""
        nxt = logits.argmax(-1)
        ok = torch.isfinite(logits).all(-1)
        both = torch.stack((nxt, ok.to(nxt.dtype))).cpu().numpy()
        return both[0], both[1].astype(bool)

    @torch.inference_mode()
    def _prefill_impl(self, tokens, true_len, caches):
        """Batched bucket prefill; logits gathered at each true length."""
        s = tokens.shape[1]
        out = self.model({"tokens": tokens}, self.cfg, caches=caches,
                         positions=torch.arange(s, device=self.dev),
                         rc=self.rc, weight_plans=self.weight_plans)
        idx = (true_len - 1).clamp(0, s - 1)
        logits = out.logits[torch.arange(tokens.shape[0],
                                         device=self.dev), idx]
        return (out.caches, *self._greedy(logits))

    @torch.inference_mode()
    def _insert_impl(self, caches, pre, row, slot, pages, true_len):
        """Lift one prefilled row into every attention layer's page pool
        and every Mamba layer's slot state (copied in place, cast to the
        slot state's dtype as the JAX engine's ``.at[].set`` casts)."""
        out = []
        for c, p in zip(caches, pre):
            if isinstance(c, ssmm.SSMState):
                c.state[slot] = p.state[row]
                c.conv[slot] = p.conv[row]
                out.append(c)
            else:
                out.append(skvc.insert_prefill(c, p, row, slot, pages,
                                               true_len))
        return out

    @torch.inference_mode()
    def _decode_impl(self, toks, pos, caches, poison=None):
        """One batched decode step over every serving slot; the rows
        flagged in ``poison`` (B,) bool get NaN logits (the ``nan_logits``
        fault), so they retire without touching their siblings' rows."""
        out = self.model({"tokens": toks[:, None]}, self.cfg,
                         caches=caches, positions=pos[:, None], rc=self.rc,
                         weight_plans=self.weight_plans)
        logits = out.logits[:, -1]
        if poison is not None:
            logits = torch.where(poison[:, None],
                                 torch.full_like(logits, float("nan")),
                                 logits)
        return (out.caches, *self._greedy(logits))

    # -- sparsity accounting ------------------------------------------
    @torch.inference_mode()
    def profile_sparsity(self, tokens, decode_steps: int = 0
                         ) -> List[dict]:
        """Per-layer StepCounts for one forward over ``tokens``.

        One prefill with the stats tape on, so every dispatch-routed
        projection (q/k/v/out, MLP up/down, head) reports its dense and
        scheduled steps and the ``executed_steps`` of the path that ran
        (the scheduled ones on the kernels' paths, dense ones on the plain
        matmul).  ``decode_steps > 0`` then greedy-decodes that many
        tokens, so with ``cfg.sparse_kv`` the bitmap-scheduled decode
        records its ``attn.score``/``attn.value`` entries, one schedule
        per batch row, and the report ends with one
        ``kvcache.posP.layerI`` occupancy entry per sparse cache.  Runs
        beside the serving state, which it does not touch.  ``[]`` in
        dense mode (nothing is routed).  Inside ``nn.axis_rules(rules,
        mesh=mesh)`` on every rank, a sharded MoE's ``moe.*`` entries are
        the mesh totals: every rank's counted steps summed.
        """
        if self.cfg.sparse_mode == "dense":
            return []
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.dev)
        if toks.ndim == 1:
            toks = toks[None]
        caches = tfm.init_caches(self.cfg, toks.shape[0], self.capacity,
                                 quantized=self.quantized, device=self.dev)
        with tape.collect() as entries:
            out = self.model({"tokens": toks}, self.cfg, caches=caches,
                             positions=torch.arange(toks.shape[1],
                                                    device=self.dev),
                             rc=self.rc, weight_plans=self.weight_plans)
            caches, pos = out.caches, toks.shape[1]
            nxt = out.logits[:, -1].argmax(-1)
            for _ in range(decode_steps):
                out = self.model(
                    {"tokens": nxt[:, None]}, self.cfg, caches=caches,
                    positions=torch.tensor([pos], device=self.dev),
                    rc=self.rc, weight_plans=self.weight_plans)
                caches, pos = out.caches, pos + 1
                nxt = out.logits[:, 0].argmax(-1)
        report = tape.summarize(entries)
        report.extend(self._cache_occupancy_entries(caches))
        return report

    @torch.inference_mode()
    def autotune_keys(self, prompt_len: int = 8,
                      decode_steps: int = 1) -> List[str]:
        """The tuning-cache keys this engine's forwards consult.

        One prefill over a synthetic prompt of ``prompt_len`` ones and
        ``decode_steps`` greedy decode steps at batch 1, with
        ``sparse_autotune`` forced on, returning the keys the call sites
        looked up (hit or miss) in that window: the M = 1 decode keys
        apart from the M = ``prompt_len`` prefill ones, so prefill and
        decode tune independently.  ``[]`` in dense mode (nothing is
        routed).  Runs beside the serving state, which it does not touch.
        """
        if self.cfg.sparse_mode == "dense":
            return []
        cfg = dataclasses.replace(self.cfg, sparse_autotune=True)
        before = set(atn.OBSERVED)
        toks = torch.ones((1, prompt_len), dtype=torch.long, device=self.dev)
        caches = tfm.init_caches(cfg, 1, self.capacity,
                                 quantized=self.quantized, device=self.dev)
        with dsp.warnings_suppressed():
            out = self.model({"tokens": toks}, cfg, caches=caches,
                             positions=torch.arange(prompt_len,
                                                    device=self.dev),
                             rc=self.rc, weight_plans=self.weight_plans)
            caches, pos = out.caches, prompt_len
            nxt = out.logits[:, -1].argmax(-1)
            for _ in range(decode_steps):
                out = self.model(
                    {"tokens": nxt[:, None]}, cfg, caches=caches,
                    positions=torch.tensor([pos], device=self.dev),
                    rc=self.rc, weight_plans=self.weight_plans)
                caches, pos = out.caches, pos + 1
                nxt = out.logits[:, 0].argmax(-1)
        return sorted(set(atn.OBSERVED) - before)

    def _cache_occupancy_entries(self, caches) -> List[dict]:
        """Per-layer sparse-cache occupancy, from the maintained bitmaps,
        named and ordered as the JAX engine names them: layer i is
        ``kvcache.pos{i % P}.layer{i // P}`` for the period P, by position
        name, then layer.  Mamba layers hold no cache to report."""
        out: List[dict] = []
        mask_w = self.cfg.sliding_window or None
        period = self.cfg.period
        order = sorted(range(len(caches)),
                       key=lambda i: (f"pos{i % period}", i // period))
        for i in order:
            c = caches[i]
            if not isinstance(c, skvc.SparseKVCache):
                continue
            rep = skvc.occupancy_report(c, mask_window=mask_w)
            out.append({"name": f"kvcache.pos{i % period}.layer"
                                f"{i // period}",
                        "written_frac": rep["written_frac"],
                        "evicted_frac": rep["evicted_frac"],
                        "quantized": rep["quantized"],
                        "capacity": rep["capacity"],
                        "block_t": rep["block_t"],
                        "n_blocks": rep["n_blocks"]})
        return out

    @torch.inference_mode()
    def _request_cost(self, req: Request) -> float:
        """StepCounts-tape admission cost: scheduled steps of one prefill
        over the request's (resume) prompt.  Dense mode routes nothing
        through the dispatch, so the cost is the prompt length there."""
        prompt = req.resume_prompt or req.prompt
        if self.cfg.sparse_mode == "dense":
            return float(len(prompt))
        toks = torch.tensor([prompt], dtype=torch.long, device=self.dev)
        with tape.collect() as entries:
            self.model({"tokens": toks}, self.cfg, caches=None,
                       positions=torch.arange(len(prompt), device=self.dev),
                       rc=self.rc, weight_plans=self.weight_plans)
        steps = sum(e["sparse_steps"] for e in tape.summarize(entries))
        return float(steps) if steps else float(len(prompt))

    # -- paged control plane ------------------------------------------
    def stats(self) -> Dict[str, int]:
        """Control-plane counters."""
        return {
            "ticks": self.ticks,
            "evictions": self.evictions,
            "prefill_calls": self.prefill_calls,
            "decode_calls": self.decode_calls,
            "tokens_emitted": self.tokens_emitted,
            "errored": self.errored,
            "pages_free": self.allocator.available,
            "pages_total": self.n_pages,
        }

    def pool_stats(self) -> Optional[dict]:
        """Per-slot paged-cache occupancy report (the first attention
        layer's: the metadata is the same in every one), or None for a
        stack without attention."""
        for c in self.caches:
            if isinstance(c, skvc.PagedSparseKVCache):
                return skvc.paged_occupancy_report(
                    c, mask_window=self.cfg.sliding_window or None)
        return None

    def health(self) -> dict:
        """JSON-serialisable control-plane snapshot: who holds which
        slot, who is backed off until when, and how the pool looks —
        what :class:`EngineStalled` carries."""
        slots = {}
        for i in range(self.slots):
            req = self.active.get(i)
            if req is None:
                slots[str(i)] = None
                continue
            slots[str(i)] = {
                "uid": req.uid, "status": req.status,
                "pos": int(self.pos[i]),
                "generated": len(req.output),
                "max_new_tokens": req.max_new_tokens,
                "admitted_tick": self.admitted_tick.get(i),
            }
        queue = [{"uid": r.uid, "status": r.status,
                  "not_before": r.not_before,
                  "preempt_retries": r.preempt_retries,
                  "deadline_ticks": r.deadline_ticks}
                 for r in self.scheduler.queue]
        return {
            "stats": self.stats(),
            "tick": self.ticks,
            "slots": slots,
            "queue": queue,
            "request_costs": {str(k): v
                              for k, v in self.scheduler._cost.items()},
            "quarantines": ssite.quarantine_report(),
            "autotune": {"hits": atn.HITS, "misses": atn.MISSES,
                         "stale": atn.STALE,
                         "observed": len(atn.OBSERVED)},
            "pool": self.pool_stats(),
        }

    def validate_state(self) -> None:
        """The serving invariants against the live engine state: the
        allocator's free list, page ownership (no page both free and
        held, held by two slots, or mapped by a slot that does not hold
        it) and the pools' occupancy against their popcounts and cursors
        (the first attention layer's pool: every layer's metadata is the
        same).  Raises :class:`repro_torch.sparse.validate.ValidationError`
        on a violation."""
        val.check_allocator(self.allocator)
        free = set(self.allocator._free)
        held_all: List[int] = []
        for slot, held in self.pages_held.items():
            held_all.extend(held)
            if free & set(held):
                raise val.ValidationError(
                    f"engine: slot {slot} holds pages that are also on "
                    f"the free list: {sorted(free & set(held))}")
            row = {int(p) for p in self.table_host[slot] if p > 0}
            if not row <= set(held):
                raise val.ValidationError(
                    f"engine: slot {slot} block table references pages "
                    f"it does not hold: {sorted(row - set(held))}")
        if len(held_all) != len(set(held_all)):
            raise val.ValidationError(
                "engine: a physical page is held by two slots")
        for c in self.caches:
            if isinstance(c, skvc.PagedSparseKVCache):
                val.check_paged_kv(c, table=self.table_host)
                break

    def _maybe_validate(self) -> None:
        if self._validate or val.enabled():
            self.validate_state()

    def _prompt_of(self, req: Request) -> List[int]:
        return req.resume_prompt or req.prompt

    def _prefill_pages(self, req: Request) -> int:
        return -(-len(self._prompt_of(req)) // self.page)

    def _push_table(self) -> None:
        # a copy: on the CPU ``as_tensor`` would alias the host table
        tbl = torch.tensor(self.table_host, device=self.dev)
        self.caches = [dataclasses.replace(c, table=tbl)
                       if isinstance(c, skvc.PagedSparseKVCache) else c
                       for c in self.caches]
        self._table_dirty = False

    def _retire(self, slot: int) -> None:
        self.allocator.free(self.pages_held.pop(slot, []))
        self.table_host[slot, :] = 0
        self.active[slot] = None
        self.admitted_tick.pop(slot, None)
        self._table_dirty = True

    def _evict_one(self) -> bool:
        """Recompute-preemption: kick one active request back to the
        queue (resuming later from prompt + generated-so-far)."""
        rows = [(i, r, self.admitted_tick.get(i, 0))
                for i, r in self.active.items() if r is not None]
        victim = self.scheduler.pick_victim(rows)
        if victim is None:
            return False
        req = self.active[victim]
        # resume point: ``output`` accumulates across preemptions, so the
        # original prompt + output is the history a re-prefill replays
        req.resume_prompt = req.prompt + req.output
        req.status = "queued"
        self._retire(victim)
        self.scheduler.requeue(req)
        self.evictions += 1
        return True

    def _requeue_with_backoff(self, req: Request) -> None:
        """Self-preemption after a failed page allocation: requeue with
        bounded exponential backoff so transient pool pressure cannot
        livelock admission."""
        req.resume_prompt = req.prompt + req.output
        req.status = "queued"
        req.preempt_retries += 1
        backoff = self.serve.backoff_ticks * (
            2 ** min(req.preempt_retries - 1, 5))
        req.not_before = self.ticks + backoff
        self.scheduler.requeue(req)

    def _error_retire(self, req: Request, reason: str,
                      slot: Optional[int] = None) -> Request:
        """Terminal error retirement (non-finite logits, blown deadline)."""
        req.done = True
        req.status = "error"
        req.error = reason
        self.errored += 1
        if slot is not None:
            self._retire(slot)
        return req

    def _append_token(self, req: Request, tok: int) -> None:
        req.output.append(tok)
        self.tokens_emitted += 1

    def _deadline_blown(self, req: Request) -> bool:
        return (req.deadline_ticks is not None
                and self.ticks - req.submit_tick >= req.deadline_ticks)

    def _expire_queued_deadlines(self) -> List[Request]:
        """Retire queued requests whose tick deadline passed while they
        waited — they must not consume a prefill."""
        expired: List[Request] = []
        q = self.scheduler.queue
        if not any(r.deadline_ticks is not None for r in q):
            return expired
        keep = [r for r in q if not self._deadline_blown(r)]
        if len(keep) != len(q):
            expired = [self._error_retire(r, "deadline")
                       for r in q if self._deadline_blown(r)]
            q.clear()
            q.extend(keep)
        return expired

    def _reclaim_swa(self) -> int:
        """Free pages whose whole block fell behind the sliding window of
        every future query — the decode schedule already excludes them,
        so the pool can recycle the memory."""
        win = self.cfg.sliding_window
        if not win:
            return 0
        freed = 0
        for i, req in self.active.items():
            if req is None:
                continue
            dead = pln.kv_blocks_reclaimable(
                self.pos[i], win, self.page, self.n_blocks)
            held = self.pages_held.get(i, [])
            for b, is_dead in enumerate(dead):
                pg = int(self.table_host[i, b])
                if is_dead and pg > 0:
                    self.table_host[i, b] = 0
                    if pg in held:
                        held.remove(pg)
                    self.allocator.free([pg])
                    freed += 1
                    self._table_dirty = True
        return freed

    def _ensure_pages(self) -> None:
        """Back the next decode write of every active slot with a real
        page, reclaiming window-dead pages first and preempting (LIFO /
        max-cost) when the pool is truly exhausted.  Retries are bounded
        (``ServeConfig.alloc_retries``): when reclaim and eviction still
        produce no page, the starved slot self-preempts with backoff."""
        for i in range(self.slots):
            if self.active[i] is None:
                continue
            lb = (self.pos[i] % self.cap_pages) // self.page
            if self.table_host[i, lb] != 0:
                continue
            got = self.allocator.alloc(1)
            attempts = 0
            while got is None and attempts < max(
                    1, self.serve.alloc_retries):
                attempts += 1
                self._reclaim_swa()
                if self.allocator.available == 0:
                    self._evict_one()
                if self.active[i] is None:
                    break              # this very request was the victim
                got = self.allocator.alloc(1)
            if self.active[i] is None:
                continue
            if got is None:
                # bounded retries exhausted: self-preempt with backoff
                req = self.active[i]
                self._retire(i)
                self._requeue_with_backoff(req)
                self.evictions += 1
                continue
            self.table_host[i, lb] = got[0]
            self.pages_held.setdefault(i, []).append(got[0])
            self._table_dirty = True

    # -- control plane ------------------------------------------------
    def submit(self, req: Request):
        if not req.prompt:
            raise ValueError("empty prompt")
        if len(req.prompt) > self.capacity - 1:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds capacity "
                f"{self.capacity} (one slot must remain for decode)")
        if self._prefill_pages(req) > self.n_pages:
            raise ValueError("prompt cannot fit the page pool")
        req.submit_tick = self.ticks
        if req.max_new_tokens <= 0:
            # nothing to generate: retire at admission with no compute
            req.done = True
            req.status = "done"
            self._early.append(req)
            return
        self.scheduler.submit(req)

    def _admit(self) -> List[Request]:
        finished: List[Request] = []
        free_slots = [i for i in range(self.slots)
                      if self.active[i] is None]
        admitted: List[Request] = []
        reserved = 0
        while len(admitted) < len(free_slots) and len(self.scheduler):
            req = self.scheduler.pop_next(
                max_pages=self.allocator.available - reserved,
                pages_of=self._prefill_pages,
                now=self.ticks)
            if req is None:
                break
            admitted.append(req)
            reserved += self._prefill_pages(req)
        if not admitted:
            return finished

        groups = pack_prefills(
            admitted, bucket=self.bucket,
            max_batch=max(1, self.serve.max_prefill_batch),
            pack=not self._exact_prefill,
            length_of=lambda r: len(self._prompt_of(r)))
        for lpad, group in groups:
            lpad = min(max(lpad, 1), self.cap_pages)
            n = len(group)
            toks = np.zeros((n, lpad), np.int64)
            lens = np.zeros((n,), np.int64)
            for r_i, req in enumerate(group):
                p = self._prompt_of(req)
                toks[r_i, :len(p)] = p
                lens[r_i] = len(p)
            # fresh per call: the port's caches are written in place
            pre = tfm.init_caches(self.cfg, n, lpad, sparse=False,
                                  full_history=True,
                                  quantized=self.quantized, device=self.dev)
            pre, nxt, ok = self._prefill_impl(
                torch.as_tensor(toks, device=self.dev),
                torch.as_tensor(lens, device=self.dev), pre)
            self.prefill_calls += 1
            for r_i, req in enumerate(group):
                if not ok[r_i]:
                    # its logits went non-finite: the request retires
                    # terminally and never touches a slot
                    finished.append(
                        self._error_retire(req, "nonfinite_logits"))
                    continue
                tok = int(nxt[r_i])
                self._append_token(req, tok)
                if (len(req.output) >= req.max_new_tokens
                        or tok == self.eos_id):
                    # the first token already finishes the request: it
                    # never occupies a slot or pages
                    req.done = True
                    req.status = "done"
                    finished.append(req)
                    continue
                nbr = self._prefill_pages(req)
                pages = self.allocator.alloc(nbr)
                if pages is None:
                    self._requeue_with_backoff(req)
                    continue
                slot = free_slots.pop(0)
                self.table_host[slot, :] = 0
                self.table_host[slot, :nbr] = pages
                self.pages_held[slot] = list(pages)
                self.caches = self._insert_impl(
                    self.caches, pre, r_i, slot, pages, int(lens[r_i]))
                self.pos[slot] = int(lens[r_i])
                self.last_tok[slot] = tok
                self.active[slot] = req
                req.status = "active"
                self.admitted_tick[slot] = self.ticks
                self._table_dirty = True
        return finished

    def step(self) -> List[Request]:
        """One engine tick: admit, one batched decode, retire."""
        self.ticks += 1
        finished = self._early
        self._early = []
        finished.extend(self._expire_queued_deadlines())
        finished.extend(self._admit())
        storm = faults.spec("preemption_storm")
        if storm is not None and storm.fire():
            self._evict_one()
        if all(r is None for r in self.active.values()):
            self._maybe_validate()
            return finished
        self._ensure_pages()
        if all(r is None for r in self.active.values()):
            self._maybe_validate()
            return finished
        if self._table_dirty:
            self._push_table()
        poison = None
        if self._logit_fault is not None:
            poison = torch.tensor(
                [r is not None and self._logit_fault.poisons(r.uid)
                 for r in (self.active[i] for i in range(self.slots))],
                device=self.dev)
        self.caches, nxt, ok = self._decode_impl(
            torch.tensor(self.last_tok, device=self.dev),
            torch.as_tensor(self.pos, dtype=torch.int32, device=self.dev),
            self.caches, poison)
        self.decode_calls += 1
        for i, req in self.active.items():
            if req is None:
                continue
            if not ok[i]:
                # this row went non-finite: retire it terminally; sibling
                # rows keep their tokens
                finished.append(
                    self._error_retire(req, "nonfinite_logits", i))
                continue
            self.pos[i] += 1
            tok = int(nxt[i])
            self._append_token(req, tok)
            self.last_tok[i] = tok
            if (len(req.output) >= req.max_new_tokens
                    or tok == self.eos_id
                    or self.pos[i] >= self.capacity - 1):
                req.done = True
                req.status = "done"
                finished.append(req)
                self._retire(i)
            elif self._deadline_blown(req):
                finished.append(self._error_retire(req, "deadline", i))
        self._maybe_validate()
        return finished

    def _idle(self) -> bool:
        return (not len(self.scheduler) and not self._early
                and all(v is None for v in self.active.values()))

    def _unfinished(self) -> List[Request]:
        live = [r for r in self.active.values() if r is not None]
        live.extend(self.scheduler.queue)
        live.extend(self._early)
        return live

    def run_to_completion(self, max_ticks: int = 10_000) -> List[Request]:
        """Drive ticks until the engine drains.

        A no-progress watchdog (``ServeConfig.watchdog_ticks``, 0
        disables) guards against livelock: if neither the finished count
        nor ``tokens_emitted`` moves for that many consecutive ticks — or
        ``max_ticks`` runs out with work still pending — the health
        snapshot is dumped and :class:`EngineStalled` raised."""
        done: List[Request] = []
        watchdog = self.serve.watchdog_ticks
        stamp = (len(done), self.tokens_emitted)
        stale = 0
        for _ in range(max_ticks):
            done.extend(self.step())
            if self._idle():
                return done
            now = (len(done), self.tokens_emitted)
            stale = stale + 1 if now == stamp else 0
            stamp = now
            if watchdog and stale >= watchdog:
                self._stall("no progress for "
                            f"{watchdog} consecutive ticks")
        if not self._idle():
            self._stall(f"max_ticks={max_ticks} exhausted with "
                        "unfinished requests")
        return done

    def _stall(self, why: str) -> None:
        health = self.health()
        unfinished = self._unfinished()
        print("[engine] STALLED: " + why, file=sys.stderr)
        print(json.dumps(health, indent=2, default=str), file=sys.stderr)
        raise EngineStalled(
            f"engine stalled: {why} "
            f"({len(unfinished)} unfinished requests)",
            health, unfinished)
