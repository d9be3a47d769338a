"""Top-k mixture-of-experts with capacity-bounded scatter dispatch.

The JAX package's ``models/moe.py``, single-device path.  Each token's
router picks its top k experts; a sort-based rank over the flattened
(token, choice) list gives each pick its slot in the expert's capacity
buffer, and picks beyond an expert's capacity are dropped (a "dropping"
MoE).  The expert FFNs run over the stacked (E, cap, d) buffers: one
batched product per projection in dense mode, or
:func:`repro_torch.sparse.site.grouped_matmul` in a sparse mode, which
with ``sparse_use_kernel`` runs K3 (K4 under ``sparse_kcondense``) over
all experts in one launch.  Empty capacity slots are zero rows, so an
expert no token picked has ``counts == 0`` in every block and its weights
are never read: dual-side sparsity the gating makes, with no pruning.

``moe_forward`` is the JAX package's local path: its ``shard_map``
expert parallelism waits for the port's multi-card work.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mlp import _activate
from repro_torch.sparse import activation as act
from repro_torch.sparse import plan as pln
from repro_torch.sparse import site
from repro_torch.sparse.weights import planned_or_array


class MoE(nn.Module):
    """router (d, E), w_up / w_gate (E, d, f) and w_down (E, f, d): the JAX
    layouts (``w_gate`` for SwiGLU experts only)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device,
                                            dtype=dtype), requires_grad=False)

        self.router = param(d, e)
        self.w_up = param(e, d, f)
        self.w_down = param(e, f, d)
        self.w_gate = param(e, d, f) if cfg.mlp_type == "swiglu" else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's stddevs, drawn in its order."""
        d, f = self.w_up.shape[1:]
        self.router.normal_(0.0, d ** -0.5, generator=generator)
        self.w_up.normal_(0.0, d ** -0.5, generator=generator)
        self.w_down.normal_(0.0, f ** -0.5, generator=generator)
        if self.w_gate is not None:
            self.w_gate.normal_(0.0, d ** -0.5, generator=generator)

    def weights(self) -> Dict[str, torch.Tensor]:
        """The expert weights by their JAX keys (the router is not
        dispatch-routed)."""
        w = {"w_up": self.w_up, "w_down": self.w_down}
        if self.w_gate is not None:
            w["w_gate"] = self.w_gate
        return w

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                plans: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_forward(self, x, cfg, plans=plans)


# the expert FFN's call sites: one per projection, with its weight's axes
_MOE_SITE_SPECS = {
    "w_up": ("moe.up", ("experts", "embed", "mlp")),
    "w_gate": ("moe.gate", ("experts", "embed", "mlp")),
    "w_down": ("moe.down", ("experts", "mlp", "embed")),
}


def moe_site(key: str) -> site.OpSite:
    name, axes = _MOE_SITE_SPECS[key]
    return site.make("grouped", name, axes=axes)


def _expert_ffn(moe: MoE, xe: torch.Tensor, cfg: ModelConfig,
                plans: Optional[Dict] = None) -> torch.Tensor:
    """The batched expert FFN over the stacked weights: xe (E, cap, d) →
    (E, cap, d).

    Dense mode multiplies every expert's buffer with ``torch.bmm`` (the
    JAX einsum); a sparse mode routes each projection through
    :func:`repro_torch.sparse.site.grouped_matmul`, planning the weights
    per call unless ``plans`` carries their cached activities."""
    w = moe.weights()
    dt = xe.dtype
    if cfg.sparse_mode == "dense":
        h = torch.bmm(xe, w["w_up"].to(dt))
        gate = torch.bmm(xe, w["w_gate"].to(dt)) if "w_gate" in w else None
        return torch.bmm(_activate(h, gate, cfg.mlp_type),
                         w["w_down"].to(dt))

    # weight mode never reads activation metadata: skip the encode
    x_in = (act.sparsify(xe, slice_k=pln.effective_slice_k(
        xe.shape[-1], cfg.sparse_slice_k))
        if cfg.sparse_mode == "dual" else xe)
    ebn = cfg.sparse_block_n if cfg.sparse_kcondense else 0

    def grouped(key: str, x_op):
        st = moe_site(key)
        y, _ = site.grouped_matmul(
            x_op, planned_or_array(w[key], plans, key, dt, cfg.sparse_slice_k,
                                   block_n=ebn, site=st),
            st, cfg)
        return y

    h = grouped("w_up", x_in)
    gate = grouped("w_gate", x_in) if "w_gate" in w else None
    h = act.activate(h, cfg.mlp_type, slice_k=pln.effective_slice_k(
        h.shape[-1], cfg.sparse_slice_k), gate=gate)
    return grouped("w_down", h)


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots in each expert's buffer for ``tokens`` tokens: the capacity
    factor's share of the picks, rounded up to a multiple of 8 (at least
    8), in Python floats as the JAX package computes it."""
    cap = int(cfg.capacity_factor * tokens * cfg.n_experts_active
              / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def router_gates(moe: MoE, xt: torch.Tensor) -> torch.Tensor:
    """(T, d) tokens → (T, E) float32 softmax gates; the router runs in
    float32 whatever the activation type."""
    logits = xt.to(torch.float32) @ moe.router.to(torch.float32)
    return torch.softmax(logits, dim=-1)


def _dispatch_local(xt: torch.Tensor, gates: torch.Tensor, e: int, k: int,
                    cap: int):
    """Top-k dispatch into (E, cap, d) buffers.

    Returns (xe, dest_e, dest_p, keep, top_g, top_i): ``dest_e``/``dest_p``
    (T, k) the expert and slot of each pick (expert ``e``, the trash row,
    for a dropped pick), ``keep`` (T, k) which picks fit, ``top_g`` the
    picks' renormalised gates and ``top_i`` their experts."""
    t, d = xt.shape
    top_g, top_i = torch.topk(gates, k, dim=-1)
    top_g = top_g / top_g.sum(-1, keepdim=True)
    # each pick's place in its expert's queue: a stable sort by expert,
    # then the offset from the start of the expert's run
    flat_e = top_i.reshape(-1)
    perm = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[perm]
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(t * k, device=xt.device) - seg_start
    pos = torch.empty_like(rank).scatter_(0, perm, rank)
    keep = pos < cap
    dest_e = torch.where(keep, flat_e, e).reshape(t, k)
    dest_p = torch.where(keep, pos, 0).reshape(t, k)
    # one k-choice at a time, into a buffer with a trash row for the
    # dropped picks: the peak intermediate is (T, d), never (T·k, d)
    xe = xt.new_zeros((e + 1, cap, d))
    for j in range(k):
        xe.index_put_((dest_e[:, j], dest_p[:, j]), xt)
    return xe[:e], dest_e, dest_p, keep.reshape(t, k), top_g, top_i


def _combine_local(ye: torch.Tensor, dest_e: torch.Tensor,
                   dest_p: torch.Tensor, kept: torch.Tensor,
                   top_g: torch.Tensor, e: int, dtype) -> torch.Tensor:
    """Gather each token's expert outputs back, weighted by its gates, one
    k-choice at a time in the activation's type: (T, d)."""
    t, k = dest_e.shape
    y = ye.new_zeros((t, ye.shape[-1]), dtype=dtype)
    for j in range(k):
        yj = ye[dest_e[:, j].clamp(0, e - 1), dest_p[:, j]]
        wj = torch.where(kept[:, j], top_g[:, j], 0.0).to(dtype)
        y = y + yj * wj[:, None]
    return y


def moe_forward(moe: MoE, x: torch.Tensor, cfg: ModelConfig,
                plans: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (y (B, S, d), the float32 auxiliary loss), dropping
    picks past each expert's capacity: the JAX package's ``_moe_local``.
    ``plans`` carries the cached weight activities of the expert
    projections (optional: without them the sparse modes plan the weights
    per call)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    xt = x.reshape(b * s, d)
    gates = router_gates(moe, xt)
    xe, dest_e, dest_p, kept, top_g, top_i = _dispatch_local(
        xt, gates, e, k, capacity(cfg, b * s))
    ye = _expert_ffn(moe, xe, cfg, plans=plans)
    y = _combine_local(ye, dest_e, dest_p, kept, top_g, e, x.dtype)
    # the Switch-style load-balancing loss: the density counts each
    # token's first pick
    density = F.one_hot(top_i[:, 0], e).to(torch.float32).mean(0)
    aux = e * torch.sum(density * gates.mean(0))
    return y.reshape(b, s, d), aux
