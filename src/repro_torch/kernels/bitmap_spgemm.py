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

On the H100 both are bound by the bytes of B's scheduled slices (at the
main path's 2 and 64 rows a bf16 product does 2·M flops per weight byte,
far under the card's ~295 flop/byte ridge).  The CUDA kernel
(``csrc/spgemm_tile.cuh``) answers with one block per output tile that
walks ``t < counts[i, j]`` only — skipped slices are bytes never read —
wide loads of each scheduled B row, a chunk of loads in flight while the
previous chunk multiplies, and masked edges instead of padded copies.

The wrapper takes ``device=None``, meaning the card.  For CPU tensors
(``device="cpu"``) it runs the plain version; for CUDA tensors it launches
the kernel or raises — there is no fallback.  ``launches`` on each wrapper
counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import device as devmod
from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _pad2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor up to (rows, cols); no copy when it fits."""
    r, c = x.shape
    if (r, c) == (rows, cols):
        return x
    return F.pad(x, (0, cols - c, 0, rows - r))


def _check(a, b, sched, counts, block_m, block_n, slice_k, kfused):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad operand shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    want = 4 if kfused else 3
    if sched.ndim != want or counts.ndim != 2:
        raise ValueError(f"schedule must be {want}-D with 2-D counts, got "
                         f"{tuple(sched.shape)} / {tuple(counts.shape)}")
    mt, nt, s = sched.shape[:3]
    if kfused and sched.shape[3] != slice_k:
        raise ValueError(f"gk lanes {sched.shape[3]} != slice_k {slice_k}")
    if tuple(counts.shape) != (mt, nt):
        raise ValueError(f"counts {tuple(counts.shape)} != ({mt}, {nt})")
    if mt * block_m < m or nt * block_n < n or s * slice_k < k:
        raise ValueError(
            f"schedule grid ({mt}, {nt}, {s}) at blocks ({block_m}, "
            f"{block_n}, {slice_k}) does not cover ({m}, {n}, {k})")
    return m, n, k, mt, nt, s


def _launch(src: str, a, b, sched, counts, block_m, block_n, slice_k,
            out_dtype, geom) -> torch.Tensor:
    """Check what the kernel takes, allocate the output and launch."""
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16 operands of one "
                        f"dtype, got {a.dtype} @ {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"kernel writes float32 or bfloat16, not {out_dtype}")
    for t, what in ((a, "a"), (b, "b"), (sched, "schedule"),
                    (counts, "counts")):
        if not t.is_contiguous():
            raise ValueError(f"kernel takes a contiguous {what}")
    for t, what in ((sched, "schedule"), (counts, "counts")):
        if t.dtype != torch.int32:
            raise TypeError(f"kernel takes an int32 {what}, got {t.dtype}")
    m, n, k, mt, nt, s = geom
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = build.function(src)(
        _DTYPE_CODE[a.dtype], int(out_dtype == torch.float32),
        a.data_ptr(), b.data_ptr(), sched.data_ptr(), counts.data_ptr(),
        out.data_ptr(), m, n, k, mt, nt, s, block_m, block_n, slice_k,
        stream)
    if rc != 0:
        raise RuntimeError(f"{src}: kernel launch failed with CUDA error "
                           f"{rc}")
    return out


# ---------------------------------------------------------------------------
# plain versions: the same schedules, walked step by step in PyTorch
# ---------------------------------------------------------------------------

def bitmap_spgemm_planned_plain(a, b, ks, counts, *, block_m: int,
                                block_n: int, slice_k: int,
                                out_dtype=None) -> torch.Tensor:
    """K1's plain version: step t adds, for every block with
    ``t < counts``, the product of its A block and B block at k-slice
    ``ks[i, j, t]``, in float32; cast once at the end."""
    m, n, k, mt, nt, s = _check(a, b, ks, counts, block_m, block_n,
                                slice_k, kfused=False)
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    av = _pad2(a, mt * block_m, s * slice_k).reshape(mt, block_m, s, slice_k)
    bv = _pad2(b, s * slice_k, nt * block_n).reshape(s, slice_k, nt, block_n)
    acc = torch.zeros(mt, nt, block_m, block_n, dtype=torch.float32,
                      device=a.device)
    cnt = torch.clamp(counts.to(torch.int64), max=s)
    ks = ks.to(torch.int64)
    for t in range(int(cnt.max()) if cnt.numel() else 0):
        ti, tj = torch.nonzero(t < cnt, as_tuple=True)
        sl = ks[ti, tj, t]
        a_t = av[ti, :, sl, :].to(torch.float32)         # (L, bm, sk)
        b_t = bv[sl, :, tj, :].to(torch.float32)         # (L, sk, bn)
        acc[ti, tj] += a_t @ b_t
    out = acc.permute(0, 2, 1, 3).reshape(mt * block_m, nt * block_n)
    return out[:m, :n].to(out_dtype)


def bitmap_spgemm_kfused_planned_plain(a, b, gk, counts, *, block_m: int,
                                       block_n: int, slice_k: int,
                                       out_dtype=None) -> torch.Tensor:
    """K2's plain version: step t adds, for every block with
    ``t < counts``, the product of A's columns and B's rows at the gathered
    positions ``gk[i, j, t, :]`` (positions past K read zero)."""
    m, n, k, mt, nt, s = _check(a, b, gk, counts, block_m, block_n,
                                slice_k, kfused=True)
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    kp = s * slice_k
    av = _pad2(a, mt * block_m, kp).reshape(mt, block_m, kp)
    bv = _pad2(b, kp, nt * block_n).reshape(kp, nt, block_n)
    acc = torch.zeros(mt, nt, block_m, block_n, dtype=torch.float32,
                      device=a.device)
    cnt = torch.clamp(counts.to(torch.int64), max=s)
    gk = gk.to(torch.int64)
    for t in range(int(cnt.max()) if cnt.numel() else 0):
        ti, tj = torch.nonzero(t < cnt, as_tuple=True)
        g = gk[ti, tj, t]                                # (L, sk)
        a_t = av[ti[:, None], :, g].transpose(1, 2)      # (L, bm, sk)
        b_t = bv[g, tj[:, None], :]                      # (L, sk, bn)
        acc[ti, tj] += a_t.to(torch.float32) @ b_t.to(torch.float32)
    out = acc.permute(0, 2, 1, 3).reshape(mt * block_m, nt * block_n)
    return out[:m, :n].to(out_dtype)


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
    dev = devmod.resolve(device)
    for t, what in ((a, "a"), (b, "b"), (ks, "ks"), (counts, "counts")):
        devmod.check_on(t, dev, what)
    kw = dict(block_m=block_m, block_n=block_n, slice_k=slice_k)
    if dev.type == "cpu":
        return bitmap_spgemm_planned_plain(a, b, ks, counts,
                                           out_dtype=out_dtype, **kw)
    geom = _check(a, b, ks, counts, kfused=False, **kw)
    out = _launch("bitmap_spgemm.cu", a, b, ks, counts, block_m, block_n,
                  slice_k, out_dtype, geom)
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
    dev = devmod.resolve(device)
    for t, what in ((a, "a"), (b, "b"), (gk, "gk"), (counts, "counts")):
        devmod.check_on(t, dev, what)
    kw = dict(block_m=block_m, block_n=block_n, slice_k=slice_k)
    if dev.type == "cpu":
        return bitmap_spgemm_kfused_planned_plain(a, b, gk, counts,
                                                  out_dtype=out_dtype, **kw)
    geom = _check(a, b, gk, counts, kfused=True, **kw)
    out = _launch("bitmap_spgemm_kfused.cu", a, b, gk, counts, block_m,
                  block_n, slice_k, out_dtype, geom)
    bitmap_spgemm_kfused_planned.launches += 1
    return out


bitmap_spgemm_planned.launches = 0
bitmap_spgemm_kfused_planned.launches = 0
