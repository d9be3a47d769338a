"""Dual-side sparse convolution through the dispatch layer.

The paper's SpCONV (§IV) composes a bitmap implicit im2col with the
SpGEMM, so the lowered matrix never exists dense.  As in the JAX
package's ``sparse/conv.py``:

* :func:`im2col_sparse` lowers an NHWC batch with the bitmap im2col —
  the kernels K5 → K6/K7 (:mod:`repro_torch.kernels.ops`) with
  ``use_kernel``, else the plain reference chain
  (:func:`repro_torch.core.im2col.im2col_bitmap`, the JAX package's jnp
  arm: a mode, not a fallback) — and emits a
  :class:`~repro_torch.sparse.activation.SparseActivation` whose bitmap
  and slice activity come from the lowered bitmap, never from a
  ``values != 0`` compare.  Layout: rows are output positions, the
  contraction is the lowered k, ``(N, P, KH·KW·C)``.
* :class:`PlannedConv` / :func:`plan_conv` hold a conv weight as a
  :class:`~repro_torch.sparse.weights.PlannedWeight` ``(KH·KW·C, F)``.
* :func:`conv2d` is ``F.conv2d`` in dense mode (the dense conv the JAX
  package leaves to XLA) and otherwise routes the lowered GEMM through
  :func:`repro_torch.sparse.dispatch.matmul` under the call's ``name``.

The glue between the kernels — :func:`lowered_to_activation` and the
row-packed → flat conversion — is plain PyTorch, as it is jnp outside
Pallas in the JAX package.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import bitmap as bm
from repro_torch.core import im2col as i2c
from repro_torch.core import stats
from repro_torch.kernels import ops as kops
from repro_torch.sparse import dispatch as dsp
from repro_torch.sparse import plan as pln
from repro_torch.sparse import tape
from repro_torch.sparse.activation import SparseActivation
from repro_torch.sparse.weights import PlannedWeight, plan_weight


@dataclasses.dataclass(frozen=True)
class PlannedConv:
    """A conv weight's plan: ``(KH·KW·C, F)`` fibers + its kernel extent.

    weight : the reshaped kernel as a :class:`PlannedWeight` (row
             ``k = (dy, dx, c)``, the order the im2col lowers in).
    kh/kw  : the kernel's spatial extent.
    site   : optional :class:`~repro_torch.sparse.site.OpSite`.
    """
    weight: PlannedWeight
    kh: int
    kw: int
    site: Optional[object] = None

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        kkc, f = self.weight.w.shape
        return (self.kh, self.kw, kkc // (self.kh * self.kw), f)

    def w4d(self) -> torch.Tensor:
        """The (KH, KW, C, F) view (dense mode's conv)."""
        return self.weight.w.reshape(self.shape)


def plan_conv(w: torch.Tensor, mask: Optional[torch.Tensor] = None,
              slice_k: int = pln.SLICE_K,
              block_n: Optional[int] = None) -> PlannedConv:
    """The static plan of a (KH, KW, C, F) conv weight, at the slice
    granularity the dispatch clamps to (``block_n`` also memoizes the
    ``condense="k"`` element activity)."""
    if w.ndim != 4:
        raise ValueError(f"plan_conv expects (KH,KW,C,F), got "
                         f"{tuple(w.shape)}")
    kh, kw, c, f = w.shape
    kkc = kh * kw * c
    pw = plan_weight(w.reshape(kkc, f),
                     mask.reshape(kkc, f) if mask is not None else None,
                     slice_k=pln.effective_slice_k(kkc, slice_k),
                     block_n=block_n)
    return PlannedConv(weight=pw, kh=kh, kw=kw)


def lowered_to_activation(lb: i2c.LoweredBitmap,
                          slice_k: int = pln.SLICE_K) -> SparseActivation:
    """:class:`LoweredBitmap` (..., KKC, ·) → inner-product-layout
    :class:`SparseActivation` (..., P, KKC).

    The mask comes from the lowered bitmap (unpacked, transposed,
    repacked over KKC), the slice activity from that mask; the values are
    decoded by popcount offset back to their positions and transposed.
    """
    vals = lb.values                                      # (..., KKC, P)
    p = vals.shape[-1]
    mask = bm.unpack_bits(lb.bitmap, axis=-1)[..., :p]    # (..., KKC, P)
    pos = torch.clamp(torch.cumsum(mask, -1) - 1, min=0)
    dense = torch.where(mask, torch.gather(vals, -1, pos),
                        torch.zeros((), dtype=vals.dtype,
                                    device=vals.device))
    mask_t = mask.transpose(-1, -2)                       # (..., P, KKC)
    sk = pln.effective_slice_k(mask_t.shape[-1], slice_k)
    return SparseActivation(
        values=dense.transpose(-1, -2),
        bitmap=bm.pack_bits_padded(mask_t, axis=-1),
        slice_act=pln.slice_activity_lhs(mask_t, sk),
        slice_k=sk)


def im2col_sparse(x: torch.Tensor, kh: int, kw: int, stride: int = 1, *,
                  slice_k: int = pln.SLICE_K,
                  use_kernel: bool = False) -> SparseActivation:
    """Bitmap implicit im2col of x (N, H, W, C) or (H, W, C), VALID →
    the lowered activation ``(N, P, KKC)`` (``(P, KKC)`` unbatched).
    ``use_kernel`` runs K5 → K6/K7 (their plain versions on the CPU);
    otherwise the reference chain.  The outputs are identical."""
    single = x.ndim == 3
    xb = x[None] if single else x
    if xb.ndim != 4:
        raise ValueError(f"im2col_sparse expects NHWC, got "
                         f"{tuple(x.shape)}")
    if use_kernel:
        lb = kops.sparse_im2col(xb, kh, kw, stride, device=xb.device)
    else:
        lb = i2c.im2col_bitmap(xb, kh, kw, stride)
    act = lowered_to_activation(lb, slice_k)
    if single:
        return SparseActivation(values=act.values[0], bitmap=act.bitmap[0],
                                slice_act=act.slice_act[0],
                                slice_k=act.slice_k)
    return act


ConvWeight = Union[torch.Tensor, PlannedConv]


def conv2d(
    x: torch.Tensor,
    w: ConvWeight,
    stride: int = 1,
    *,
    mode: str = "dense",
    block_m: int = 128,
    block_n: int = 128,
    slice_k: int = pln.SLICE_K,
    use_kernel: bool = False,
    condense: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    collect_stats: bool = False,
    name: str = "conv",
    autotune: bool = False,
    tune_sparsity: Optional[float] = None,
) -> Tuple[torch.Tensor, Optional[stats.StepCounts]]:
    """2-D convolution with dual-side sparse scheduling (VALID padding).

    x: (N, H, W, C); w: (KH, KW, C, F) tensor or :class:`PlannedConv`.
    Returns ``(y (N, OH, OW, F), StepCounts or None)``.  Every mode
    computes the convolution: ``dense`` is ``F.conv2d`` with the dense
    GEMM-equivalent schedule on the tape; ``weight``/``dual`` lower with
    :func:`im2col_sparse` and run one GEMM over all N images through the
    dispatch (K1, or K2 under ``condense="k"``, with ``use_kernel``).
    ``autotune`` consults the tuning cache under ``op="conv"`` keys, so a
    conv's lowered GEMM (M = N·OH·OW, K = KH·KW·C, N = F) tunes apart from
    LM projections of the same bucketed geometry.
    """
    if x.ndim != 4:
        raise ValueError(f"conv2d expects NHWC input, got {tuple(x.shape)}")
    if mode not in dsp.MODES:
        raise ValueError(f"mode must be one of {dsp.MODES}, got {mode!r}")
    if isinstance(w, PlannedConv):
        kh, kw, c_w, f = w.shape
        w_gemm: Union[torch.Tensor, PlannedWeight] = w.weight
        w4 = w.w4d()
    else:
        if w.ndim != 4:
            raise ValueError(f"conv2d expects (KH,KW,C,F) weights, got "
                             f"{tuple(w.shape)}")
        kh, kw, c_w, f = w.shape
        w_gemm = w.reshape(kh * kw * c_w, f)
        w4 = w
    n_im, h, wd, c = x.shape
    if c != c_w:
        raise ValueError(f"channel mismatch: input {c} vs weight {c_w}")
    oh, ow = i2c.out_size(h, kh, stride), i2c.out_size(wd, kw, stride)
    p = oh * ow
    kkc = kh * kw * c

    if mode == "dense":
        if use_kernel or condense:
            warnings.warn(
                f"sparse.conv2d ({name}): use_kernel/condense have no "
                "effect in dense mode — executing F.conv2d (executed == "
                "dense steps)", RuntimeWarning, stacklevel=2)
        ct = x.dtype if out_dtype is None else torch.promote_types(
            x.dtype, out_dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(ct),
                     w4.permute(3, 2, 0, 1).to(ct), stride=stride)
        y = y.permute(0, 2, 3, 1).to(out_dtype or x.dtype)
        steps = None
        if collect_stats or tape.active():
            # the GEMM-equivalent dense schedule, as matmul's dense branch
            bm_, bn_, sk_ = pln.clamp_geometry(n_im * p, f, kkc, block_m,
                                               block_n, slice_k)
            dense = torch.tensor(pln._cdiv(n_im * p, bm_) * pln._cdiv(f, bn_)
                                 * pln._cdiv(kkc, sk_))
            steps = stats.StepCounts(dense=dense, sparse=dense,
                                     tiles_skipped=torch.tensor(0))
            tape.record(name, steps)
        return y, steps

    act = im2col_sparse(x, kh, kw, stride, slice_k=slice_k,
                        use_kernel=use_kernel)
    y2, steps = dsp.matmul(act, w_gemm, mode=mode, block_m=block_m,
                           block_n=block_n, slice_k=slice_k,
                           use_kernel=use_kernel, condense=condense,
                           out_dtype=out_dtype, collect_stats=collect_stats,
                           name=name, autotune=autotune,
                           tune_sparsity=tune_sparsity, op="conv")
    return y2.reshape(n_im, oh, ow, f), steps
