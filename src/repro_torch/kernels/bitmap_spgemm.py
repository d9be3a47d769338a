"""K1 and K2: the dual-side sparse GEMM kernels, their wrappers and their
plain versions.

* K1, :func:`bitmap_spgemm_planned` — replaces the JAX package's TPU
  kernel ``kernels/bitmap_spgemm.py::bitmap_spgemm_planned``
  (``_spgemm_kernel``).  ``C = A @ B``; output block (i, j) of
  ``block_m × block_n`` visits only its front-packed active k-slices
  ``ks[i, j, :counts[i, j]]``, accumulating in float32.
* K2, :func:`bitmap_spgemm_kfused_planned` — replaces
  ``kernels/bitmap_spgemm.py::bitmap_spgemm_kfused_planned``
  (``_spgemm_kfused_kernel``).  Step t of block (i, j) gathers the
  ``slice_k`` contraction positions ``gk[i, j, t, :]``;
  ``counts == ceil(nnz_AND / slice_k)``.

On the H100 both are bound by the bytes of B's scheduled slices at the
main path's 2 and 64 rows (a bf16 product does 2·M flops per weight byte,
far under the card's ~295 flop/byte ridge) and by their flops at
whisper's 6000-row encoder.  bfloat16 operands run on the tensor-core
kernel ``csrc/spgemm_mma.cuh``: mma.sync fed from a ring of cp.async
stages, and — where the output tiles fill fewer than two waves of SMs —
each tile's schedule split over several CUDA blocks (:func:`split_count`,
:func:`split_ranges`), whose float32 partials a second launch sums in
split order.  float32 operands run on the SIMT kernel
``csrc/spgemm_tile.cuh`` (exact against a float32 walk), unsplit.  Both
walk ``t < counts[i, j]`` only — skipped slices are bytes never read —
and mask the edges instead of padding.

:func:`bitmap_spgemm` and :func:`bitmap_spgemm_kfused` are the
on-the-fly entries: they plan the schedule from the operands (the JAX
package's ``plan_slices`` / element planning), then launch K1 / K2;
:func:`bitmap_spgemm_kcondensed` is the dense :func:`kcondense` pre-pass
before K1, the reference the fused K2 is held against.

The wrapper takes ``device=None``, meaning the card.  For CPU tensors
(``device="cpu"``) it runs the plain version; for CUDA tensors it launches
the kernel or raises — there is no fallback.  ``launches`` on each wrapper
counts its calls on the card, one each (a split call's second launch, the
sum of the partials, is not counted apart).  The checks, the launch, the
route rule (:func:`route`) and the plain walks take a leading problem
axis, so the grouped K3/K4 (:mod:`repro_torch.kernels.grouped_spgemm`)
share them.
"""
from __future__ import annotations

import array
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import device as devmod
from repro_torch.kernels import build
from repro_torch.sparse import plan as pln

_OUT_DTYPES = (torch.float32, torch.bfloat16)
# the kernel a call runs on, the first launch word
# (csrc/spgemm_entry.cuh; K1/K2 take simt and mma)
ROUTES = {"simt": 0, "mma": 1, "narrow": 2, "mixed": 3}
GROUPED_SOURCES = ("grouped_spgemm.cu", "grouped_spgemm_kfused.cu")
# K3/K4's narrow-N kernel (csrc/spgemm_grouped.cuh): bf16 products of at
# most NARROW_N columns, B staged whole in shared memory, K <= NARROW_MAX_K
NARROW_N = 16
NARROW_MAX_K = 2048

# the tensor-core kernel's CUDA block (csrc/spgemm_mma.cuh): the smallest
# of MMA_ROWS rows that holds block_m (128 at a time beyond) by MMA_COLS
# columns
MMA_ROWS = (16, 32, 64, 128)
MMA_COLS = 128
# split tiles' schedules when their CUDA blocks fill fewer than
# SPLIT_BELOW_WAVES waves of SMs, into enough shares for SPLIT_WAVES waves
# (more blocks than can be resident, so none waits on a short last wave),
# each share walking at least MIN_SPLIT_STEPS steps
SPLIT_BELOW_WAVES = 2
SPLIT_WAVES = 8
MIN_SPLIT_STEPS = 8


def _pad_last2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad the last two axes up to (rows, cols); no copy when they
    fit."""
    r, c = x.shape[-2:]
    if (r, c) == (rows, cols):
        return x
    return F.pad(x, (0, cols - c, 0, rows - r))


def check_problem(a, b, sched, counts, block_m, block_n, slice_k, kfused):
    """Check a stacked product A (E, M, K) @ B (E, K, N) against its
    schedule (E, Mt, Nt, S[, slice_k]) / counts (E, Mt, Nt); returns
    (e, m, n, k, mt, nt, s)."""
    if (a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0]
            or a.shape[2] != b.shape[1]):
        raise ValueError(f"bad operand shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    e, m, k = a.shape
    n = b.shape[2]
    want = 5 if kfused else 4
    if sched.ndim != want or counts.ndim != 3:
        raise ValueError(f"schedule must be {want}-D with 3-D counts "
                         f"(a leading problem axis), got "
                         f"{tuple(sched.shape)} / {tuple(counts.shape)}")
    e2, mt, nt, s = sched.shape[:4]
    if kfused and sched.shape[4] != slice_k:
        raise ValueError(f"gk lanes {sched.shape[4]} != slice_k {slice_k}")
    if e2 != e or tuple(counts.shape) != (e, mt, nt):
        raise ValueError(f"counts {tuple(counts.shape)} != ({e}, {mt}, "
                         f"{nt}) for schedule {tuple(sched.shape)}")
    if mt * block_m < m or nt * block_n < n or s * slice_k < k:
        raise ValueError(
            f"schedule grid ({mt}, {nt}, {s}) at blocks ({block_m}, "
            f"{block_n}, {slice_k}) does not cover ({m}, {n}, {k})")
    return e, m, n, k, mt, nt, s


def mma_blocks(e: int, mt: int, nt: int, block_m: int, block_n: int) -> int:
    """CUDA blocks of the tensor-core kernel for an (E, Mt, Nt) tile grid,
    one split each."""
    rows = next((r for r in MMA_ROWS if r >= block_m), MMA_ROWS[-1])
    return e * mt * -(-block_m // rows) * nt * -(-block_n // MMA_COLS)


def split_count(blocks: int, s: int, sms: int, *, m: int, k: int) -> int:
    """Shares each tile's S-step schedule is cut into.

    1 once ``blocks`` CUDA blocks fill :data:`SPLIT_BELOW_WAVES` waves of
    ``sms`` SMs.  Otherwise enough shares for :data:`SPLIT_WAVES` waves,
    but each walking at least :data:`MIN_SPLIT_STEPS` steps, and with the
    float32 partials of an (M, ·) output (8 bytes an element: stored, then
    read back) no larger than a quarter of the bf16 rows of depth K
    (2 bytes an element) they split: so 6000-row products never split.
    """
    if blocks <= 0 or blocks >= SPLIT_BELOW_WAVES * sms:
        return 1
    want = -(-SPLIT_WAVES * sms // blocks)
    by_bytes = (2 * k) // (4 * 8 * m) if m > 0 else want
    return max(1, min(want, s // MIN_SPLIT_STEPS, by_bytes))


def split_ranges(counts: torch.Tensor, s: int, splits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``q``'s steps ``[t0[q], t1[q])`` of every tile, as the
    tensor-core kernel walks them: contiguous shares of
    ``per = ceil(min(counts, S) / splits)`` steps, the last ones short or
    empty.  Returns int64 (splits, *counts.shape) tensors."""
    steps = counts.to(torch.int64).clamp(0, s)
    per = (steps + splits - 1) // splits
    q = torch.arange(splits, device=counts.device).view(
        (splits,) + (1,) * counts.ndim)
    t0 = torch.minimum(q * per, steps)
    return t0, torch.minimum(t0 + per, steps)


def route(src: str, a_dtype, b_dtype, n: int, k: int) -> str:
    """The kernel ``csrc/<src>`` runs an (E, M, K) @ (E, K, N) product on,
    by rule from the types and N, K (a key of :data:`ROUTES`):

    * bf16 @ bf16: ``"narrow"`` for K3/K4 when ``n <= NARROW_N`` and
      ``k <= NARROW_MAX_K`` (the decode score), else ``"mma"``, the
      128-column tensor-core kernel with split schedules;
    * float32 @ float32: ``"simt"``, exact against a float32 walk;
    * float32 @ bf16, K3/K4 only: ``"mixed"`` (the decode value, V read as
      stored).

    Any other pair raises ``TypeError``."""
    grouped = src in GROUPED_SOURCES
    if a_dtype == b_dtype == torch.bfloat16:
        narrow = grouped and n <= NARROW_N and k <= NARROW_MAX_K
        return "narrow" if narrow else "mma"
    if a_dtype == b_dtype == torch.float32:
        return "simt"
    if grouped and a_dtype == torch.float32 and b_dtype == torch.bfloat16:
        return "mixed"
    raise TypeError(
        f"kernel takes float32 or bfloat16 operands of one dtype"
        f"{', or float32 @ bfloat16' if grouped else ''}, got {a_dtype} @ "
        f"{b_dtype}")


def route_splits(kind: str, geom, block_m: int, block_n: int,
                 sms: int) -> int:
    """Shares each tile's schedule is cut into on route ``kind``: the
    tensor-core kernel's :func:`split_count`, 1 on every other route.
    ``geom`` is :func:`check_problem`'s (e, m, n, k, mt, nt, s)."""
    if kind != "mma":
        return 1
    e, m, n, k, mt, nt, s = geom
    return split_count(mma_blocks(e, mt, nt, block_m, block_n), s, sms,
                       m=m, k=k)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(src: str, a, b, sched, counts, block_m, block_n, slice_k,
           out_dtype, geom) -> torch.Tensor:
    """Check what the kernel in ``csrc/<src>`` takes, allocate the
    (E, M, N) output and, for a split schedule, its float32 workspace, and
    launch on the current stream on the :func:`route` the operands
    take."""
    e, m, n, k, mt, nt, s = geom
    kind = route(src, a.dtype, b.dtype, n, k)
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"kernel writes float32 or bfloat16, not {out_dtype}")
    for t, what in ((a, "a"), (b, "b"), (sched, "schedule"),
                    (counts, "counts")):
        if not t.is_contiguous():
            raise ValueError(f"kernel takes a contiguous {what}")
    for t, what in ((sched, "schedule"), (counts, "counts")):
        if t.dtype != torch.int32:
            raise TypeError(f"kernel takes an int32 {what}, got {t.dtype}")
    index = a.get_device()
    out = a.new_empty((e, m, n), dtype=out_dtype)
    splits = route_splits(kind, geom, block_m, block_n, _sm_count(index))
    # freed on return: later work on this stream runs after the kernel
    ws = (a.new_empty((splits, e, m, n), dtype=torch.float32)
          if splits > 1 else None)
    # the launch words of csrc/spgemm_entry.cuh, one ctypes argument; the
    # raw current stream, without building a torch.cuda.Stream
    words = array.array("q", (
        ROUTES[kind], int(out_dtype == torch.float32), a.data_ptr(),
        b.data_ptr(), sched.data_ptr(), counts.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), e, m, n, k, mt, nt, s, block_m,
        block_n, slice_k, splits, torch._C._cuda_getCurrentRawStream(index)))
    rc = build.function(src)(words.buffer_info()[0])
    if rc != 0:
        raise RuntimeError(f"{src}: kernel launch failed with CUDA error "
                           f"{rc}")
    return out


# ---------------------------------------------------------------------------
# plain versions: the same schedules, walked step by step in PyTorch, over
# a leading problem axis (E = 1 for K1/K2)
# ---------------------------------------------------------------------------

def walk_slices(a, b, ks, counts, *, block_m: int, block_n: int,
                slice_k: int, out_dtype=None) -> torch.Tensor:
    """The plain K1/K3 walk: step t adds, for every block with
    ``t < counts``, the product of its A block and B block at k-slice
    ``ks[e, i, j, t]``, in float32; cast once at the end.  a (E, M, K),
    b (E, K, N) → (E, M, N)."""
    e, m, n, k, mt, nt, s = check_problem(a, b, ks, counts, block_m,
                                          block_n, slice_k, kfused=False)
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    av = _pad_last2(a, mt * block_m, s * slice_k).reshape(
        e, mt, block_m, s, slice_k)
    bv = _pad_last2(b, s * slice_k, nt * block_n).reshape(
        e, s, slice_k, nt, block_n)
    acc = torch.zeros(e, mt, nt, block_m, block_n, dtype=torch.float32,
                      device=a.device)
    cnt = torch.clamp(counts.to(torch.int64), max=s)
    ks = ks.to(torch.int64)
    for t in range(int(cnt.max()) if cnt.numel() else 0):
        te, ti, tj = torch.nonzero(t < cnt, as_tuple=True)
        sl = ks[te, ti, tj, t]
        a_t = av[te, ti, :, sl, :].to(torch.float32)    # (L, bm, sk)
        b_t = bv[te, sl, :, tj, :].to(torch.float32)    # (L, sk, bn)
        acc[te, ti, tj] += a_t @ b_t
    out = acc.permute(0, 1, 3, 2, 4).reshape(e, mt * block_m, nt * block_n)
    return out[:, :m, :n].to(out_dtype)


def walk_gathers(a, b, gk, counts, *, block_m: int, block_n: int,
                 slice_k: int, out_dtype=None) -> torch.Tensor:
    """The plain K2/K4 walk: step t adds, for every block with
    ``t < counts``, the product of A's columns and B's rows at the
    gathered positions ``gk[e, i, j, t, :]`` (positions past K read
    zero)."""
    e, m, n, k, mt, nt, s = check_problem(a, b, gk, counts, block_m,
                                          block_n, slice_k, kfused=True)
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    kp = s * slice_k
    av = _pad_last2(a, mt * block_m, kp).reshape(e, mt, block_m, kp)
    bv = _pad_last2(b, kp, nt * block_n).reshape(e, kp, nt, block_n)
    acc = torch.zeros(e, mt, nt, block_m, block_n, dtype=torch.float32,
                      device=a.device)
    cnt = torch.clamp(counts.to(torch.int64), max=s)
    gk = gk.to(torch.int64)
    for t in range(int(cnt.max()) if cnt.numel() else 0):
        te, ti, tj = torch.nonzero(t < cnt, as_tuple=True)
        g = gk[te, ti, tj, t]                           # (L, sk)
        a_t = av[te[:, None], ti[:, None], :, g].transpose(1, 2)
        b_t = bv[te[:, None], g, tj[:, None], :]        # (L, sk, bn)
        acc[te, ti, tj] += a_t.to(torch.float32) @ b_t.to(torch.float32)
    out = acc.permute(0, 1, 3, 2, 4).reshape(e, mt * block_m, nt * block_n)
    return out[:, :m, :n].to(out_dtype)


def bitmap_spgemm_planned_plain(a, b, ks, counts, **kw) -> torch.Tensor:
    """K1's plain version: :func:`walk_slices` on one problem."""
    return walk_slices(a[None], b[None], ks[None], counts[None], **kw)[0]


def bitmap_spgemm_kfused_planned_plain(a, b, gk, counts,
                                       **kw) -> torch.Tensor:
    """K2's plain version: :func:`walk_gathers` on one problem."""
    return walk_gathers(a[None], b[None], gk[None], counts[None], **kw)[0]


def run(src: str, plain, a, b, sched, counts, *, kfused: bool,
        block_m: int, block_n: int, slice_k: int, out_dtype, device
        ) -> torch.Tensor:
    """The body of every wrapper: (E, ...) operands on ``device`` (None:
    the card) → the plain walk for CPU tensors, else the kernel in
    ``csrc/<src>``; there is no fallback."""
    dev = devmod.resolve(device)
    devmod.check_all_on(dev, a=a, b=b, schedule=sched, counts=counts)
    kw = dict(block_m=block_m, block_n=block_n, slice_k=slice_k)
    if dev.type == "cpu":
        return plain(a, b, sched, counts, out_dtype=out_dtype, **kw)
    geom = check_problem(a, b, sched, counts, kfused=kfused, **kw)
    return launch(src, a, b, sched, counts, block_m, block_n, slice_k,
                  out_dtype, geom)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def bitmap_spgemm_planned(a: torch.Tensor, b: torch.Tensor,
                          ks: torch.Tensor, counts: torch.Tensor, *,
                          block_m: int = 256, block_n: int = 256,
                          slice_k: int = 128, out_dtype=None,
                          device=None) -> torch.Tensor:
    """K1: ``a @ b`` over the slice schedule ``ks (Mt, Nt, S)``/``counts``.

    ``out_dtype`` defaults to the promoted input dtype; accumulation is
    float32.  ``device=None`` means the card.
    """
    out = run("bitmap_spgemm.cu", walk_slices, a[None], b[None], ks[None],
              counts[None], kfused=False, block_m=block_m, block_n=block_n,
              slice_k=slice_k, out_dtype=out_dtype, device=device)[0]
    if out.is_cuda:
        bitmap_spgemm_planned.launches += 1
    return out


def bitmap_spgemm_kfused_planned(a: torch.Tensor, b: torch.Tensor,
                                 gk: torch.Tensor, counts: torch.Tensor, *,
                                 block_m: int = 256, block_n: int = 256,
                                 slice_k: int = 128,
                                 out_dtype: Optional[torch.dtype] = None,
                                 device=None) -> torch.Tensor:
    """K2: ``a @ b`` over the element-condensed schedule
    ``gk (Mt, Nt, S, slice_k)``/``counts``.  ``device=None`` means the
    card."""
    out = run("bitmap_spgemm_kfused.cu", walk_gathers, a[None], b[None],
              gk[None], counts[None], kfused=True, block_m=block_m,
              block_n=block_n, slice_k=slice_k, out_dtype=out_dtype,
              device=device)[0]
    if out.is_cuda:
        bitmap_spgemm_kfused_planned.launches += 1
    return out


bitmap_spgemm_planned.launches = 0
bitmap_spgemm_kfused_planned.launches = 0


# ---------------------------------------------------------------------------
# on-the-fly entries: plan from the operands, then launch
# ---------------------------------------------------------------------------

def plan_slices(a: torch.Tensor, b: torch.Tensor, block_m: int,
                block_n: int, slice_k: int = pln.SLICE_K
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's schedule of ``a (M, K) @ b (K, N)`` from the operands' non-zero
    masks: (ks (Mt, Nt, S), counts (Mt, Nt)) int32, front-packed with a
    repeat-last tail (:func:`repro_torch.sparse.plan.plan_operands`)."""
    return pln.plan_operands(a, b, block_m, block_n, slice_k)


def on_the_fly(a, b, block_m, block_n, slice_k, device, ndim=2):
    """Resolve the device, check the operands lie on it and are an
    ``ndim``-D product ((M, K) @ (K, N), or (E, C, K) @ (E, K, N) for the
    grouped entries) and clamp the blocks: (device, (block_m, block_n,
    slice_k))."""
    dev = devmod.resolve(device)
    devmod.check_all_on(dev, a=a, b=b)
    if (a.ndim != ndim or b.ndim != ndim or a.shape[:-2] != b.shape[:-2]
            or a.shape[-1] != b.shape[-2]):
        raise ValueError(f"bad operand shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    return dev, pln.clamp_geometry(a.shape[-2], b.shape[-1], a.shape[-1],
                                   block_m, block_n, slice_k)


def bitmap_spgemm(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
                  block_n: int = 256, block_k: int = 256,
                  slice_k: int = pln.SLICE_K,
                  out_dtype: Optional[torch.dtype] = None,
                  device=None) -> torch.Tensor:
    """Dual-side sparse ``a @ b`` with on-the-fly planning, then K1.

    ``block_k`` is kept for the JAX signature (k-slices are the unit).
    Blocks clamp to small problems by one rule on every device
    (:func:`repro_torch.sparse.plan.clamp_geometry`), never below 8.  The
    JAX entry keeps block_n at 128 or more when compiled for the TPU (its
    lane width) and clamps to 8 only in interpret mode; the port does not
    widen it: K1 masks its edges instead of padding to a lane width, so a
    narrow block is legal on the card, and one rule keeps CPU and card
    schedules equal to each other and to the JAX CPU schedules.
    ``device=None`` means the card.
    """
    del block_k
    dev, (bm, bn, sk) = on_the_fly(a, b, block_m, block_n, slice_k,
                                    device)
    ks, counts = plan_slices(a, b, bm, bn, sk)
    return bitmap_spgemm_planned(a.contiguous(), b.contiguous(), ks, counts,
                                 block_m=bm, block_n=bn, slice_k=sk,
                                 out_dtype=out_dtype, device=dev)


def kcondense(a: torch.Tensor, b: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Condense the contraction at element granularity: k is active iff
    column k of A and row k of B both hold a non-zero (the paper's
    condensing AND, Fig. 4c); active k's are stably front-packed.
    Returns (a_cond, b_cond, n_active); buffers keep capacity K, and the
    product of the condensed operands is ``a @ b``.  A dense pre-pass (two
    gathered copies), kept as the reference of the fused K2."""
    act = (a != 0).any(0) & (b != 0).any(1)
    order, nact = pln.stable_partition(act)
    order = order.to(torch.int64)
    return a[:, order], b[order], nact


def bitmap_spgemm_kcondensed(a: torch.Tensor, b: torch.Tensor, *,
                             block_m: int = 256, block_n: int = 256,
                             slice_k: int = pln.SLICE_K,
                             out_dtype: Optional[torch.dtype] = None,
                             device=None) -> torch.Tensor:
    """:func:`kcondense`, then :func:`bitmap_spgemm` (K1) on the condensed
    operands."""
    a_c, b_c, _ = kcondense(a, b)
    return bitmap_spgemm(a_c, b_c, block_m=block_m, block_n=block_n,
                         slice_k=slice_k, out_dtype=out_dtype, device=device)


def bitmap_spgemm_kfused(a: torch.Tensor, b: torch.Tensor, *,
                         block_m: int = 256, block_n: int = 256,
                         slice_k: int = pln.SLICE_K,
                         out_dtype: Optional[torch.dtype] = None,
                         device=None) -> torch.Tensor:
    """Fused-K-condensed ``a @ b``: element planning
    (:func:`repro_torch.sparse.plan.plan_kcondensed`), then K2.  Blocks
    clamp as in :func:`bitmap_spgemm`.  ``device=None`` means the card."""
    dev, (bm, bn, sk) = on_the_fly(a, b, block_m, block_n, slice_k,
                                    device)
    kp = pln.plan_kcondensed(pln.element_activity_lhs(a, bm),
                             pln.element_activity_rhs(b, bn), sk)
    return bitmap_spgemm_kfused_planned(
        a.contiguous(), b.contiguous(), kp.gk, kp.counts, block_m=bm,
        block_n=bn, slice_k=sk, out_dtype=out_dtype, device=dev)
