"""The two-level bitmap planner.

Every sparse matmul schedules its work from the same recipe:

1. *slice activity* — reduce each operand's non-zero mask to k-slice
   granularity (``slice_k`` contraction positions per slice);
2. *block reduction* — reduce slice activity to output-block granularity
   (``block_m`` rows of A / ``block_n`` cols of B per block);
3. *front-pack* — for each output block, stably push the indices of
   active slices (A-side AND B-side, the paper's condensing bitmap AND,
   Fig. 4c) to the front of the schedule, repeating the last active index
   in the inactive tail.

Under ``condense="k"`` the AND is taken per contraction index instead and
packed into per-block gather maps (:func:`plan_kcondensed`).  Every step
takes leading axes, so the grouped schedules of K3/K4 (a leading problem
axis) come from the same functions.  The decode KV planners
(:func:`plan_kv_decode`) schedule cache blocks from occupancy AND the
causal/window mask.

The schedules keep the JAX package's layouts — front-packing, the
repeat-last tails, int32 — so that they compare with it bit for bit.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import stats

SLICE_K = 128   # contraction depth per k-slice = unit of sparsity skip
MIN_BLOCK = 8   # smallest block edge clamp_geometry shrinks a block to


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def _pad(x: torch.Tensor, pads) -> torch.Tensor:
    """``F.pad`` with zeros/False, without a copy when nothing is padded
    (a full-width weight mask is gigabytes)."""
    return F.pad(x, pads) if any(pads) else x


# ---------------------------------------------------------------------------
# step 1: slice activity
# ---------------------------------------------------------------------------

def slice_activity_lhs(a: torch.Tensor, slice_k: int) -> torch.Tensor:
    """(..., K) values or mask → (..., S) bool: slice s is active for a row
    iff the row has a non-zero in columns [s*slice_k, (s+1)*slice_k)."""
    *lead, k = a.shape
    s = _cdiv(k, slice_k)
    mask = _pad(a != 0, (0, s * slice_k - k))
    return mask.reshape(*lead, s, slice_k).any(-1)


def slice_activity_rhs(b: torch.Tensor, slice_k: int) -> torch.Tensor:
    """(..., K, N) values or mask → (..., S, N) bool: slice s is active
    for a column iff the column has a non-zero in rows
    [s*slice_k, (s+1)*slice_k)."""
    *lead, k, n = b.shape
    s = _cdiv(k, slice_k)
    mask = _pad(b != 0, (0, 0, 0, s * slice_k - k))
    return mask.reshape(*lead, s, slice_k, n).any(-2)


# ---------------------------------------------------------------------------
# step 2: block reduction
# ---------------------------------------------------------------------------

def block_reduce_lhs(row_act: torch.Tensor, block_m: int) -> torch.Tensor:
    """(..., M, S) per-row activity → (..., Mt, S) per-block-row activity."""
    *lead, m, s = row_act.shape
    mt = _cdiv(m, block_m)
    padded = _pad(row_act, (0, 0, 0, mt * block_m - m))
    return padded.reshape(*lead, mt, block_m, s).any(-2)


def block_reduce_rhs(col_act: torch.Tensor, block_n: int) -> torch.Tensor:
    """(..., S, N) per-column activity → (..., S, Nt) per-block-col
    activity."""
    *lead, s, n = col_act.shape
    nt = _cdiv(n, block_n)
    padded = _pad(col_act, (0, nt * block_n - n))
    return padded.reshape(*lead, s, nt, block_n).any(-1)


# ---------------------------------------------------------------------------
# step 3: front-pack ("condensing")
# ---------------------------------------------------------------------------

def stable_partition(act: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable partition of indices along the last axis.

    act: (..., S) bool.  Returns (order (..., S) int32, counts (...)
    int32): per fiber, the active indices in ascending order followed by
    the inactive indices in ascending order — ``argsort(~act, stable)``,
    built from two cumsums and one permutation-inverting scatter.
    """
    s = act.shape[-1]
    act = act.to(torch.bool)
    counts = act.sum(-1, dtype=torch.int64)
    rank_active = torch.cumsum(act, -1) - 1
    rank_inactive = torch.cumsum(~act, -1) - 1
    pos = torch.where(act, rank_active, counts[..., None] + rank_inactive)
    src = torch.arange(s, device=act.device).expand_as(pos)
    order = torch.empty_like(pos).scatter_(-1, pos, src)
    return order.to(torch.int32), counts.to(torch.int32)


def front_pack(act: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-front-pack active indices along the last axis.

    Returns (indices (..., S) int32, counts (...) int32): the active
    indices of each fiber in ascending order, then the last active index
    repeated over the inactive tail (all zeros for empty fibers).
    """
    s = act.shape[-1]
    order, counts = stable_partition(act)
    arange = torch.arange(s, device=act.device)
    last = torch.clamp(counts.to(torch.int64) - 1, min=0)[..., None]
    idx = torch.where(arange < counts[..., None], order,
                      torch.gather(order, -1, last))
    return idx, counts


def _and(col: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """(..., Mt, X) A-side and (..., X, Nt) B-side activity → (..., Mt,
    Nt, X) AND, contiguous, so the schedules built from it are too (the
    kernels take contiguous schedules)."""
    return (col[..., :, None, :]
            & row.transpose(-1, -2)[..., None, :, :]).contiguous()


def plan_from_activity(col: torch.Tensor, row: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Mt, S) A-side and (..., S, Nt) B-side block activity → the
    K1/K3 schedule (ks (..., Mt, Nt, S), counts (..., Mt, Nt)).  A problem
    with fewer occupied rows has more empty block-rows; the repeat-last
    tails keep the grid rectangular."""
    return front_pack(_and(col, row))


def counts_from_activity(col: torch.Tensor, row: torch.Tensor
                         ) -> torch.Tensor:
    """Per-block active-slice counts without building the schedule."""
    return _and(col, row).sum(-1, dtype=torch.int32)


def plan_operands(a: torch.Tensor, b: torch.Tensor, block_m: int,
                  block_n: int, slice_k: int = SLICE_K
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K1 schedule straight from dense operands a (..., M, K) and
    b (..., K, N): the same schedule as planning from cached activation
    and weight activities at this geometry."""
    col = block_reduce_lhs(slice_activity_lhs(a, slice_k), block_m)
    row = block_reduce_rhs(slice_activity_rhs(b, slice_k), block_n)
    return plan_from_activity(col, row)


# ---------------------------------------------------------------------------
# element-granular K-condensation schedules
# ---------------------------------------------------------------------------

def element_activity_lhs(a: torch.Tensor, block_m: int) -> torch.Tensor:
    """(..., M, K) values or mask → (..., Mt, K) bool: k is active for
    block-row i iff some row of the block has a non-zero at column k."""
    *lead, m, k = a.shape
    mt = _cdiv(m, block_m)
    mask = _pad(a != 0, (0, 0, 0, mt * block_m - m))
    return mask.reshape(*lead, mt, block_m, k).any(-2)


def element_activity_rhs(b: torch.Tensor, block_n: int) -> torch.Tensor:
    """(..., K, N) values or mask → (..., K, Nt) bool: k is active for
    block-col j iff some column of the block has a non-zero at row k."""
    *lead, k, n = b.shape
    nt = _cdiv(n, block_n)
    mask = _pad(b != 0, (0, nt * block_n - n))
    return mask.reshape(*lead, k, nt, block_n).any(-1)


class KPlan(NamedTuple):
    """A per-output-block packed active-k schedule (``plan_kcondensed``).

    gk     : (..., Mt, Nt, S, slice_k) int32 — lane l of condensed step t
             gathers contraction index ``gk[..., t, l]``: first the
             block's active k's in ascending order, then the inactive
             ones (zero outer products), which may lie in [K, S*slice_k).
    counts : (..., Mt, Nt) int32 — executed steps, ``ceil(nnz/slice_k)``.
    nnz    : (..., Mt, Nt) int32 — element-AND active k's per block.
    """
    gk: torch.Tensor
    counts: torch.Tensor
    nnz: torch.Tensor


def _kpack(act: torch.Tensor, slice_k: int) -> KPlan:
    """(..., K) element activity → packed-k schedule at ``slice_k``."""
    *lead, k = act.shape
    s = _cdiv(k, slice_k)
    act = _pad(act, (0, s * slice_k - k))
    order, nnz = stable_partition(act)
    counts = (nnz + slice_k - 1) // slice_k
    return KPlan(gk=order.reshape(*lead, s, slice_k),
                 counts=counts.to(torch.int32), nnz=nnz)


def plan_kcondensed(col: torch.Tensor, row: torch.Tensor,
                    slice_k: int = SLICE_K) -> KPlan:
    """(..., Mt, K) A-side and (..., K, Nt) B-side element activity → the
    K2/K4 schedule: the bitmap AND stable-front-packed per output block."""
    return _kpack(_and(col, row), slice_k)


def kcondensed_counts(col: torch.Tensor, row: torch.Tensor,
                      slice_k: int = SLICE_K) -> torch.Tensor:
    """Condensed-step counts ``ceil(nnz / slice_k)`` without gather maps."""
    nnz = _and(col, row).sum(-1, dtype=torch.int32)
    return (nnz + slice_k - 1) // slice_k


# ---------------------------------------------------------------------------
# decode-path KV-cache planning
# ---------------------------------------------------------------------------

def kv_slot_visibility(kpos: torch.Tensor, qpos,
                       window: Optional[int]) -> torch.Tensor:
    """Which cache slots the query at ``qpos`` may attend to: written
    (kpos >= 0), causal (kpos <= qpos) and, with a sliding window,
    kpos > qpos - window — the mask of ``attention._attend_block``."""
    valid = (kpos >= 0) & (kpos <= qpos)
    if window is not None:
        valid &= kpos > (qpos - window)
    return valid


def slot_block_reduce(mask: torch.Tensor, block_t: int) -> torch.Tensor:
    """(..., T) per-slot mask → (..., NB) per-block any-reduction."""
    *lead, t = mask.shape
    nb = _cdiv(t, block_t)
    return _pad(mask, (0, nb * block_t - t)).reshape(
        *lead, nb, block_t).any(-1)


def kv_decode_slots(occ_slots: torch.Tensor, kpos: torch.Tensor, qpos,
                    window: Optional[int]) -> torch.Tensor:
    """Slot-level decode schedule: occupancy AND the causal/window mask.
    Occupancy equals ``kpos >= 0``, so this is also the dense path's
    softmax mask, bit for bit."""
    return occ_slots & kv_slot_visibility(kpos, qpos, window)


class KVDecodePlan(NamedTuple):
    """One decode step's cache schedule (:func:`plan_kv_decode`).

    slots  : (T,) bool scheduled slots (:func:`kv_decode_slots`).
    blocks : (NB,) bool, the same at cache-block granularity.
    idx    : (NB,) int32 front-packed scheduled block indices, repeat-last
             tail.
    count  : () int32 number of scheduled blocks.
    """
    slots: torch.Tensor
    blocks: torch.Tensor
    idx: torch.Tensor
    count: torch.Tensor


def plan_kv_decode(occ_slots: torch.Tensor, kpos: torch.Tensor, qpos,
                   window: Optional[int], block_t: int) -> KVDecodePlan:
    """Front-packed cache-block schedule for one decode step: a block is
    scheduled iff it holds an occupied slot the query may see."""
    slots = kv_decode_slots(occ_slots, kpos, qpos, window)
    blocks = slot_block_reduce(slots, block_t)
    idx, count = front_pack(blocks)
    return KVDecodePlan(slots=slots, blocks=blocks, idx=idx, count=count)


def kv_blocks_reclaimable(pos: int, window: Optional[int], block_t: int,
                          n_blocks: int) -> List[bool]:
    """Which cache blocks no future query can attend (host-side): the
    paged engine's page-reclaim predicate.

    In a full-history cache (logical slot i holds token i), block b spans
    slots [b·block_t, (b+1)·block_t); once its last slot falls out of the
    sliding window of the current cursor, ``(b+1)·block_t - 1 <= pos -
    window``, it is out for every later query too (the window only moves
    forward), and the decode schedule already skips it.  All False
    without a window.
    """
    if not window:
        return [False] * n_blocks
    horizon = pos - window  # slots <= horizon are invisible forever
    return [(b + 1) * block_t - 1 <= horizon for b in range(n_blocks)]


# ---------------------------------------------------------------------------
# step-count accounting and geometry
# ---------------------------------------------------------------------------

def counts_to_steps(counts: torch.Tensor, n_slices: int
                    ) -> stats.StepCounts:
    """(Mt, Nt) schedule counts → StepCounts; dense work is Mt·Nt·S.
    Grouped (E, Mt, Nt) counts sum into one entry of E·Mt·Nt·S."""
    return stats.StepCounts(
        dense=torch.tensor(counts.numel() * n_slices),
        sparse=counts.sum(),
        tiles_skipped=(counts == 0).sum())


# The grouped (E, ...) forms of K3/K4 are the same functions over a leading
# problem axis.  The JAX package's names for them, kept so the parity tests
# call each function by the name it has there:
plan_grouped_activity = plan_from_activity
grouped_counts_from_activity = counts_from_activity
plan_grouped_kcondensed = plan_kcondensed
grouped_kcondensed_counts = kcondensed_counts
grouped_counts_to_steps = counts_to_steps


def effective_slice_k(k: int, slice_k: int = SLICE_K) -> int:
    """The slice granularity the dispatch uses for a contraction of depth
    ``k``."""
    return min(slice_k, max(8, k))


# ---------------------------------------------------------------------------
# shard-local plans
# ---------------------------------------------------------------------------

def shard_plan(ks: torch.Tensor, counts: torch.Tensor, start: int,
               size: int, axis: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Restrict a front-packed schedule to a contiguous fiber range.

    ks (..., S) / counts (...) along a leading fiber axis (the expert axis
    of a grouped plan, or the block-row axis of a 2-D plan).  Because
    :func:`front_pack` is independent per fiber, slicing the *plan* along
    a fiber axis is exactly the plan of the sliced *activity*: each rank's
    block of the global plan is its local plan, with no re-planning (the
    identity the sharded MoE rests on)."""
    return (ks.narrow(axis, start, size), counts.narrow(axis, start, size))


def kplan_shardable(k: int, n_shards: int, slice_k: int = SLICE_K) -> bool:
    """Can a cached k-side slice activity be viewed per shard?

    When a weight's contraction axis of depth ``k`` is split ``n_shards``
    ways (tensor-parallel ``w_down``), the cached ``(…, S, N)`` activity
    slices along S into valid per-shard plans only if shard boundaries
    align with slice boundaries *and* the dispatch clamps to the same
    granularity locally as globally (:func:`effective_slice_k`).  Fibers
    along S are not independent under :func:`front_pack`, so this slices
    the *activity*, never a packed schedule.  False when the view would
    be invalid: callers then drop the cache and plan from the local weight
    shard (the same schedule, planned per call)."""
    if n_shards <= 1:
        return True
    if k % n_shards:
        return False
    k_loc = k // n_shards
    sk = effective_slice_k(k, slice_k)
    return effective_slice_k(k_loc, slice_k) == sk and k_loc % sk == 0


def clamp_geometry(m: int, n: int, k: int, block_m: int, block_n: int,
                   slice_k: int) -> Tuple[int, int, int]:
    """Shrink blocks to small problems, never below :data:`MIN_BLOCK`.

    One rule on every device, so CPU and card schedules are the same.
    At full width the projections' ``n`` is at least 128 and no clamp
    applies, but the attention decode sites clamp: ``attn.score``'s
    block_n and ``attn.value``'s block_m both shrink to G, the query
    heads per KV head (12 for nemotron-4-340b).
    """
    block_m = min(block_m, max(MIN_BLOCK, m))
    block_n = min(block_n, max(MIN_BLOCK, n))
    return block_m, block_n, effective_slice_k(k, slice_k)


# ---------------------------------------------------------------------------
# knob validity (the autotuner's contract)
# ---------------------------------------------------------------------------

SUBLANE = 8     # row unit of block_m and slice_k
LANE = 128      # block_n unit on the card: the kernels' 128-column CUDA
                # blocks (kernels/bitmap_spgemm.py MMA_COLS)
CPU_LANE = 8    # block_n unit on the CPU, where the plain walks run
F32_BYTES = 4   # accumulator dtype
# The CPU's panel budget: the JAX package's VMEM rule, kept for the plain
# walks so that a CPU tuning cache admits what the JAX package's CPU
# (interpret-mode) cache admits, key for key.
VMEM_BYTES = 16 * 2 ** 20


def _round_up(x: int, unit: int) -> int:
    return _cdiv(max(x, 1), unit) * unit


def kfused_panel_bytes(block_m: int, block_n: int, k: int, slice_k: int,
                       dtype_bytes: int = 4) -> int:
    """The CPU rule's footprint of K2/K4 for one output block: full-K
    (block_m, Kp) and (Kp, block_n) operand panels plus the float32
    accumulator, Kp = ceil(K / slice_k) · slice_k (the JAX package's TPU
    kernels keep these panels resident).  On the card K2/K4 stage no
    panel: they share K1/K3's ring
    (``kernels/bitmap_spgemm.stage_bytes``), whatever K."""
    kp = _cdiv(max(k, 1), slice_k) * slice_k
    return ((block_m * kp + kp * block_n) * dtype_bytes
            + block_m * block_n * F32_BYTES)


def slice_panel_bytes(block_m: int, block_n: int, slice_k: int,
                      dtype_bytes: int = 4) -> int:
    """The CPU rule's footprint of K1/K3 for one step: a (block_m,
    slice_k) A block, a (slice_k, block_n) B block and the float32
    accumulator (the JAX package's TPU rule)."""
    return ((block_m * slice_k + slice_k * block_n) * dtype_bytes
            + block_m * block_n * F32_BYTES)


def knobs_valid(m: int, n: int, k: int, block_m: int, block_n: int,
                slice_k: int, *, use_kernel: bool = False,
                condense: Optional[str] = None, interpret: bool = False,
                dtype_bytes: int = 4, grouped: bool = False) -> bool:
    """Is a (block_m, block_n, slice_k) knob vector valid for an (m, n, k)
    problem?

    The predicate every served or swept knob vector passes (a stale cache
    entry must fall back to the config constants, never reach a kernel
    it cannot launch).  ``interpret`` says where the product runs: True
    for CPU tensors (the plain walks), False on the card.

    * tile divisibility — block_m and slice_k multiples of 8; block_n a
      multiple of the lane unit, 128 on the card (the kernels' column
      blocks), 8 on the CPU;
    * no over-tiling — each knob at most its dimension rounded up to its
      unit (``clamp_geometry`` would shrink a larger one, so the served
      vector would not be the one that was timed);
    * slice_k <= K rounded up to 8;
    * for the kernel backends, what a block stages fits: on the card the
      shared memory of every route the product may take
      (``kernels/bitmap_spgemm.stage_bytes`` and ``width_routes``,
      ``grouped`` for K3/K4) within the card's budget, and a width some
      route takes; on the CPU the JAX package's panel rule
      (:func:`kfused_panel_bytes` / :func:`slice_panel_bytes` within
      :data:`VMEM_BYTES`), so CPU keys admit what the JAX package's CPU
      keys admit.

    On an H100 (232448 B a block may opt into) no route's staging reaches
    the budget: the largest, the tensor-core ring at 128 rows, is 144384
    B.  There the card's rule reduces to the unit rules and a route for
    the width; the budget binds only on a card with less shared memory
    per block.
    """
    if min(m, n, k, block_m, block_n, slice_k) <= 0:
        return False
    lane = CPU_LANE if interpret else LANE
    if block_m % SUBLANE or block_n % lane or slice_k % SUBLANE:
        return False
    if block_m > _round_up(m, SUBLANE) or block_n > _round_up(n, lane):
        return False
    if slice_k > _round_up(k, SUBLANE):
        return False
    if not use_kernel:
        return True
    if interpret:
        if condense == "k":
            panel = kfused_panel_bytes(block_m, block_n, k, slice_k,
                                       dtype_bytes)
        else:
            panel = slice_panel_bytes(block_m, block_n, slice_k,
                                      dtype_bytes)
        return panel <= VMEM_BYTES
    from repro_torch.kernels import bitmap_spgemm as bsk
    routes = bsk.width_routes(dtype_bytes, n, k, grouped)
    budget = bsk.smem_budget()
    return bool(routes) and all(bsk.stage_bytes(r, block_m, k) <= budget
                                for r in routes)
