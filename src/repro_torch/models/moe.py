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

Under a mesh (:func:`repro_torch.models.nn.axis_rules` with ``mesh=``)
``moe_forward`` runs the JAX package's ``shard_map`` MoE on
``torch.distributed`` (:func:`_moe_shard_map`): experts split over the
``"experts"`` rule's mesh axis when they divide it (expert parallelism,
the capacity buffers and their bitmaps through ``all_to_all``), the FFN
dimension split otherwise (tensor parallelism, the partial products
summed with ``all_reduce``), the batch over the ``"batch"`` rule's axes.
A module runs sharded once :func:`shard_moe_` has cut its router, its
expert weights and their cached plans to the rank's blocks, or once
:func:`mark_sharded_` has marked it for a caller that hands it its
blocks (the sharded train step, whose masters lie under the train rules'
specs).  Its collectives carry gradients (``distributed.comm``), and in
the train step (``nn.local_batch``: x is the rank's rows) the block's
backward is ``shard_map``'s transpose: the outputs' cotangents divided by
the number of ranks that compute the same rows, and the cotangent of x
and of each weight block summed over the mesh axes its spec leaves out.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import stats
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as shd
from repro_torch.models import nn as tnn
from repro_torch.models.mlp import _activate
from repro_torch.sparse import activation as act
from repro_torch.sparse import dispatch as dsp
from repro_torch.sparse import plan as pln
from repro_torch.sparse import site
from repro_torch.sparse import tape
from repro_torch.sparse import weights as spw
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
        # how the parameters are cut over a mesh (None: held whole)
        self.shard: Optional[MoEShard] = None

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


def _expert_ffn(w: Dict[str, torch.Tensor], xe, cfg: ModelConfig,
                plans: Optional[Dict] = None, *, collect_stats: bool = False,
                out_dtype=None) -> Tuple[torch.Tensor, Dict]:
    """The batched expert FFN over stacked weights ``w`` (by their JAX
    keys): xe (E, cap, d) → ye (E, cap, d).

    Dense mode multiplies every expert's buffer with ``torch.bmm`` (the
    JAX einsum); a sparse mode routes each projection through
    :func:`repro_torch.sparse.site.grouped_matmul`, planning the weights
    per call unless ``plans`` carries their cached activities.  ``xe`` may
    be a :class:`~repro_torch.sparse.activation.SparseActivation` whose
    bitmap came through the expert ``all_to_all`` (the sharded MoE): it
    is never encoded again, and the dense branch reads its values.

    This is the shard-local FFN: the sharded MoE calls it on the rank's
    buffers and its blocks of the weights and plans.  Returns ``(ye,
    steps)``: ``steps`` maps tape names to each routed product's
    StepCounts when ``collect_stats`` (the sharded MoE sums them over the
    mesh and records the totals), empty otherwise.  ``out_dtype``
    (optional) pins every routed product's accumulation type.
    """
    xv = dsp._values(xe)
    dt = xv.dtype
    steps: Dict[str, object] = {}
    if cfg.sparse_mode == "dense":
        h = torch.bmm(xv, w["w_up"].to(dt))
        gate = torch.bmm(xv, w["w_gate"].to(dt)) if "w_gate" in w else None
        return torch.bmm(_activate(h, gate, cfg.mlp_type),
                         w["w_down"].to(dt)), steps

    # weight mode never reads activation metadata, so skip the encode; an
    # xe that is already a SparseActivation carries the bitmap encoded
    # before the permute: never encode it again
    if isinstance(xe, act.SparseActivation):
        x_in = xe if cfg.sparse_mode == "dual" else xe.values
    else:
        x_in = (act.sparsify(xe, slice_k=pln.effective_slice_k(
            xe.shape[-1], cfg.sparse_slice_k))
            if cfg.sparse_mode == "dual" else xe)
    ebn = cfg.sparse_block_n if cfg.sparse_kcondense else 0

    def grouped(key: str, x_op):
        st = moe_site(key)
        xv = dsp._values(x_op)
        kwr = site.resolve(st, cfg, m=xv.shape[1], n=w[key].shape[-1],
                           k=xv.shape[-1], e=xv.shape[0], dtype=dt,
                           device=xv.device)
        if out_dtype is not None:
            kwr["out_dtype"] = out_dtype
        y, steps[st.name] = site.grouped_matmul(
            x_op, planned_or_array(w[key], plans, key, dt, cfg.sparse_slice_k,
                                   block_n=ebn, site=st),
            st, cfg, collect_stats=collect_stats, resolved=kwr)
        return y

    h = grouped("w_up", x_in)
    gate = grouped("w_gate", x_in) if "w_gate" in w else None
    h = act.activate(h, cfg.mlp_type, slice_k=pln.effective_slice_k(
        h.shape[-1], cfg.sparse_slice_k), gate=gate)
    ye = grouped("w_down", h)
    return ye, {k: v for k, v in steps.items() if v is not None}


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
    picks past each expert's capacity.  ``plans`` carries the cached
    weight activities of the expert projections (optional: without them
    the sparse modes plan the weights per call).

    Under a mesh (``nn.axis_rules(rules, mesh=mesh)``) it runs sharded
    (:func:`_moe_shard_map`, on a module :func:`shard_moe_` has cut for
    that mesh); otherwise on the whole module (:func:`_moe_local`)."""
    if tnn.current_mesh() is not None:
        return _moe_shard_map(moe, x, cfg, plans=plans)
    if moe.shard is not None:
        raise ValueError("moe_forward: this MoE holds one rank's blocks of "
                         "its weights; run it under nn.axis_rules(rules, "
                         "mesh=...) with the mesh it was sharded for")
    return _moe_local(moe, x, cfg, plans=plans)


def _moe_local(moe: MoE, x: torch.Tensor, cfg: ModelConfig,
               plans: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``_moe_local``: one device, the whole batch."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    xt = x.reshape(b * s, d)
    gates = router_gates(moe, xt)
    xe, dest_e, dest_p, kept, top_g, top_i = _dispatch_local(
        xt, gates, e, k, capacity(cfg, b * s))
    ye, _ = _expert_ffn(moe.weights(), xe, cfg, plans=plans)
    y = _combine_local(ye, dest_e, dest_p, kept, top_g, e, x.dtype)
    return y.reshape(b, s, d), _aux_loss(gates, top_i, e)


def _aux_loss(gates: torch.Tensor, top_i: torch.Tensor, e: int
              ) -> torch.Tensor:
    """The Switch-style load-balancing loss: the density counts each
    token's first pick."""
    density = F.one_hot(top_i[:, 0], e).to(torch.float32).mean(0)
    return e * torch.sum(density * gates.mean(0))


# ---------------------------------------------------------------------------
# the sharded MoE on torch.distributed
# ---------------------------------------------------------------------------

_PLAN_KEYS = ("w_up", "w_gate", "w_down")


def _mesh_axes(rule, mesh) -> Tuple[str, ...]:
    """A rule's mesh axes that the mesh has."""
    parts = shd.entry_axes(rule)
    return tuple(p for p in parts if p in mesh.mesh_dim_names)


def _mesh_key(mesh) -> tuple:
    return comm.mesh_layout(mesh)


@dataclasses.dataclass
class MoEShard:
    """How a MoE's parameters are cut over a mesh (:func:`shard_moe_`).

    ``tp_axes``: the mesh axes of the ``"experts"`` rule, ``tp`` their
    size; ``dp_axes``/``dp`` those of the ``"batch"`` rule.  Expert
    parallel (``ep_mode``: E divides by tp > 1) holds E/tp whole experts;
    tensor parallel holds every expert's 1/tp of the FFN dimension.  The
    router, ``w_up`` and ``w_gate`` are cut along d over the data axes
    (gathered at each call).  ``key`` names the mesh; ``plans``: the
    rank's blocks of the cached plan activities at
    ``slice_k`` (``w_down``'s dropped when ``down_ok`` is false: its
    tensor-parallel k-plan cannot be sliced, so it is planned per call
    from the local block), and under kcondense their ``"<key>@elem"``
    element activities at ``block_n`` (0: none cached)."""
    key: tuple
    tp_axes: Tuple[str, ...]
    dp_axes: Tuple[str, ...]
    tp: int
    dp: int
    ep_mode: bool
    down_ok: bool
    plans: Dict[str, torch.Tensor]
    slice_k: int
    block_n: int
    specs: Dict[str, shd.PartitionSpec]


def moe_specs(cfg: ModelConfig, mesh, rules: Dict[str, Any]
              ) -> Tuple[Dict[str, shd.PartitionSpec], bool, tuple, tuple]:
    """(each parameter's spec, ep_mode, tp_axes, dp_axes) of the sharded
    MoE under ``rules`` on ``mesh``: the JAX package's ``shard_map``
    in_specs for x's data axes at their full size."""
    tp_axes = _mesh_axes(rules.get("experts"), mesh)
    dp_axes = _mesh_axes(rules.get("batch"), mesh)
    tp = shd.axes_size(mesh, tp_axes)
    ep_mode = cfg.n_experts % tp == 0 and tp > 1
    ep, dp = shd._entry(tp_axes), shd._entry(dp_axes)
    if ep_mode:
        up = shd.PartitionSpec(ep, dp, None)
        down = shd.PartitionSpec(ep, None, None)
    else:
        up = shd.PartitionSpec(None, dp, ep)
        down = shd.PartitionSpec(None, ep, None)
    specs = {"router": shd.PartitionSpec(dp, None), "w_up": up,
             "w_down": down}
    if cfg.mlp_type == "swiglu":
        specs["w_gate"] = up
    return specs, ep_mode, tp_axes, dp_axes


def _new_shard(cfg: ModelConfig, mesh, rules: Dict[str, Any],
               plans: Dict[str, torch.Tensor], block_n: int) -> MoEShard:
    specs, ep_mode, tp_axes, dp_axes = moe_specs(cfg, mesh, rules)
    for axes in (tp_axes, dp_axes):
        # the collectives take blocks in group-rank order
        order = comm.group_order(mesh, axes) if axes else []
        if order != sorted(order):
            raise ValueError(f"shard_moe_: mesh axes {axes} must follow "
                             f"the mesh's order {mesh.mesh_dim_names}")
    tp = shd.axes_size(mesh, tp_axes)
    return MoEShard(key=_mesh_key(mesh), tp_axes=tp_axes, dp_axes=dp_axes,
                    tp=tp, dp=shd.axes_size(mesh, dp_axes), ep_mode=ep_mode,
                    down_ok=ep_mode or pln.kplan_shardable(
                        cfg.d_ff, tp, cfg.sparse_slice_k),
                    plans=plans, slice_k=cfg.sparse_slice_k, block_n=block_n,
                    specs=specs)


def mark_sharded_(moe: MoE, cfg: ModelConfig, mesh, rules: Dict[str, Any]
                  ) -> MoE:
    """Mark ``moe`` for the sharded MoE on ``mesh`` under ``rules`` without
    cutting it or caching plans: a caller that holds the parameters
    elsewhere (``sharding.shard_params_``, the train step's masters under
    the train rules) hands the MoE its blocks under
    ``moe.shard.specs`` through ``functional_call``.  Returns ``moe``."""
    if moe.shard is not None:
        raise ValueError("mark_sharded_: the MoE is already sharded")
    moe.shard = _new_shard(cfg, mesh, rules, {}, 0)
    return moe


@torch.no_grad()
def shard_moe_(moe: MoE, cfg: ModelConfig, mesh, rules: Dict[str, Any]
               ) -> MoE:
    """Cut ``moe`` in place to this rank's blocks under ``rules`` on
    ``mesh``: its router, expert weights and the cached plan activities
    of its expert projections (planned from the whole weights at
    ``cfg.sparse_slice_k``, and under ``cfg.sparse_kcondense`` their
    element activities at ``cfg.sparse_block_n``, then cut by the plan
    specs: ``sharding.plan_specs_from_sites``).  The whole tensors are dropped,
    so a rank's expert memory falls by the expert-parallel factor.
    Serving's cut: the train step's masters are cut under the train
    rules instead (:func:`mark_sharded_`).  Returns ``moe``."""
    if moe.shard is not None:
        raise ValueError("shard_moe_: the MoE is already sharded")
    sh = _new_shard(cfg, mesh, rules, {}, 0)
    specs, ep_mode, tp_axes, down_ok = sh.specs, sh.ep_mode, sh.tp_axes, \
        sh.down_ok
    f, sk, tp = cfg.d_ff, cfg.sparse_slice_k, sh.tp
    bn = cfg.sparse_block_n if cfg.sparse_kcondense else 0
    whole = spw.plan_layer_weights(moe.weights(), slice_k=sk,
                                   block_n=bn or None)
    sites = {k: moe_site(k) for k in _PLAN_KEYS}
    plan_specs = shd.plan_specs_from_sites(
        sites, shd._entry(tp_axes), ep_mode=ep_mode, k_shardable=down_ok)
    # an element activity (…, K, N/block_n) is exact per row of K, so it
    # cuts like its weight along K; along N (tensor-parallel w_up and
    # w_gate) only at whole column blocks
    elem_specs = shd.plan_specs_from_sites(
        sites, shd._entry(tp_axes), ep_mode=ep_mode, k_shardable=True)
    n_cut_ok = ep_mode or bool(bn) and (f // tp) % bn == 0
    plans = {}
    for key, a in whole.items():
        base, _, elem = key.partition("@")
        if base == "w_down" and not down_ok:
            continue
        if elem and base != "w_down" and not n_cut_ok:
            continue
        spec = elem_specs[base] if elem else plan_specs[base]
        plans[key] = shd.local_slice(a, spec, mesh).clone()
    for name, spec in specs.items():
        block = shd.local_slice(getattr(moe, name), spec, mesh).clone()
        setattr(moe, name, nn.Parameter(block, requires_grad=False))
    sh.plans, sh.block_n = plans, bn
    moe.shard = sh
    return moe


def shard_moe_layers_(model: nn.Module, cfg: ModelConfig, mesh,
                      rules: Dict[str, Any]) -> int:
    """:func:`shard_moe_` on every MoE of ``model``; returns how many."""
    n = 0
    for module in model.modules():
        if isinstance(module, MoE):
            shard_moe_(module, cfg, mesh, rules)
            n += 1
    return n


def shard_plans(moe: MoE, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The cached plan activities of a sharded MoE, the rank's blocks
    (``transformer.plan_weight_activities`` of a sharded model); the
    element activities only under kcondense at the ``block_n`` they were
    cut at."""
    sh = moe.shard
    if cfg.sparse_slice_k != sh.slice_k:
        raise ValueError(f"the MoE was sharded with plans at slice_k "
                         f"{sh.slice_k}, not {cfg.sparse_slice_k}")
    elem = cfg.sparse_kcondense and cfg.sparse_block_n == sh.block_n
    return {k: v for k, v in sh.plans.items() if elem or "@" not in k}


def _check_shard(moe: MoE, mesh, rules: Dict[str, Any]) -> "MoEShard":
    sh = moe.shard
    if (sh is None or sh.key != _mesh_key(mesh)
            or sh.tp_axes != _mesh_axes(rules.get("experts"), mesh)
            or sh.dp_axes != _mesh_axes(rules.get("batch"), mesh)):
        raise ValueError("moe_forward: the MoE is not sharded for the "
                         "active mesh and rules; call "
                         "moe.shard_moe_(module, cfg, mesh, rules) first")
    return sh


def _to_experts(v: torch.Tensor, group, tp: int) -> torch.Tensor:
    """(E, cap, ...) on every rank → (E/tp, tp·cap, ...): each rank's
    local experts, the capacity buffers of every source rank side by side
    in rank order (``all_to_all``, split 0, concat 1)."""
    out = comm.all_to_all(v, group)
    el, rest = v.shape[0] // tp, v.shape[1:]
    return out.reshape(tp, el, *rest).transpose(0, 1).reshape(
        el, tp * rest[0], *rest[1:])


def _from_experts(y: torch.Tensor, group, tp: int) -> torch.Tensor:
    """The inverse permute: (E/tp, tp·cap, ...) → (E, cap, ...), each
    source rank's capacity slice back to it (split 1, concat 0)."""
    el, cap = y.shape[0], y.shape[1] // tp
    v = y.reshape(el, tp, cap, *y.shape[2:]).transpose(0, 1).reshape(
        tp * el, cap, *y.shape[2:])
    return comm.all_to_all(v, group)


def _sum_steps(steps: Dict[str, stats.StepCounts], group, dev
               ) -> Dict[str, stats.StepCounts]:
    """Each StepCounts summed over ``group`` (the whole mesh)."""
    out = {}
    for name, sc in steps.items():
        t = torch.stack([torch.as_tensor(v, device=dev).to(torch.int64)
                         for v in sc])
        t = comm.all_reduce(t, group)
        out[name] = stats.StepCounts(dense=t[0], sparse=t[1],
                                     tiles_skipped=t[2])
    return out


def _moe_shard_map(moe: MoE, x: torch.Tensor, cfg: ModelConfig,
                   plans: Optional[Dict] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's expert-parallel / tensor-parallel MoE block
    (``_moe_shard_map``) on ``torch.distributed``.  Every rank holds the
    whole ``x``.

    * the data axes — the largest of the ``"batch"`` rule's mesh axes
      that divide B split the batch: a rank dispatches its own rows with
      the capacity of its own tokens.  The router and the up/gate weights,
      held cut along d over the data axes, are gathered
      (``all_gather``), the aux loss is averaged over them, and the
      outputs gathered back;
    * EP branch (E divides by tp > 1) — in a sparse ``dual`` mode the
      capacity buffers are encoded *before* the expert ``all_to_all``; the
      packed bitmap and the slice activity (as uint8) ride a second one
      through the same permute, so the local experts (K3, K4 under
      ``sparse_kcondense``) plan from that metadata without encoding
      again.  The outputs come back through a third;
    * TP branch — experts replicated, FFN dimension split; the partial
      down-projections are summed (``all_reduce``).  A cached ``w_down``
      k-plan that cannot be sliced (``plan.kplan_shardable``) was
      dropped at :func:`shard_moe_`; passing plans warns once and the
      weight is planned per call from the local block;
    * StepCounts are collected with the tape suppressed, summed over the
      whole mesh, and recorded after the block, so the tape shows the
      mesh totals (``Engine.profile_sparsity``).  Every rank must run
      with a tape alike: the sum is a collective.

    Inside ``nn.local_batch`` (the sharded train step) ``x`` is already
    the rank's block over every data axis and the output stays the
    rank's block.  The ranks that share a data block (the other mesh
    axes, ``rep`` of them) compute the same rows, so, as ``shard_map``'s
    transpose does, the cotangents of y and of the aux loss are divided
    by ``rep`` and those of x and of each weight block summed over the
    mesh axes their specs leave out (``comm.scale_grad``/``sum_grad``):
    the weight blocks' gradients are then those of the sum of the data
    blocks' losses, alike on every rank that holds the block.
    """
    mesh, rules = tnn.current_mesh(), tnn.current_rules()
    sh = _check_shard(moe, mesh, rules)
    e, k = cfg.n_experts, cfg.n_experts_active
    b, s, d = x.shape
    # the data axes of this call: the train step's (``nn.local_batch``);
    # serving, the largest run of the batch rule's axes whose size divides
    # B (b=16 on ("pod","data")=2×16 → "data")
    dpc = tnn.local_batch_axes()
    local = dpc is not None
    if not local:
        dpc = shd._best_divisible(sh.dp_axes, b, shd.mesh_sizes(mesh))
    dpn = shd.axes_size(mesh, dpc)
    cap = capacity(cfg, (b if local else b // dpn) * s)
    weights = {"router": moe.router, **moe.weights()}
    rep = 1
    if local:
        rest = tuple(a for a in mesh.mesh_dim_names if a not in dpc)
        rep = shd.axes_size(mesh, rest)
        x = comm.sum_grad(x, comm.axis_group(mesh, rest) if rep > 1
                          else None)
        for key, wt in weights.items():
            named = set(shd.spec_axes(sh.specs[key]))
            left = tuple(a for a in mesh.mesh_dim_names if a not in named)
            weights[key] = comm.sum_grad(
                wt, comm.axis_group(mesh, left)
                if shd.axes_size(mesh, left) > 1 else None)
    sparse_on = cfg.sparse_mode != "dense"
    collect = sparse_on and tape.active()
    if plans is not None and sparse_on and not sh.down_ok:
        dsp.warn_once(
            f"moe:w_down-plan-unshardable:{cfg.d_ff}:{sh.tp}:"
            f"{cfg.sparse_slice_k}",
            f"moe shard_map: cached w_down k-plan cannot be sliced over "
            f"{sh.tp} tensor-parallel shards (d_ff={cfg.d_ff} does not "
            f"align with slice_k={cfg.sparse_slice_k} boundaries); "
            "re-planning from the local weight shard instead (the same "
            "schedule, stats unchanged)")
    ploc = plans if sparse_on else None

    if dpc and not local:
        lo, hi = shd.block_range(b, shd._entry(dpc), mesh)
        x_blk = x[lo:hi]
    else:
        x_blk = x
    xt = x_blk.reshape(-1, d)
    g_dp = comm.axis_group(mesh, sh.dp_axes) if sh.dp > 1 else None
    w = {"w_up": comm.all_gather(weights["w_up"], g_dp, dim=1),
         "w_down": weights["w_down"]}
    if "w_gate" in weights:
        w["w_gate"] = comm.all_gather(weights["w_gate"], g_dp, dim=1)
    router = comm.all_gather(weights["router"], g_dp, dim=0)
    gates = torch.softmax(xt.to(torch.float32) @ router.to(torch.float32),
                          dim=-1)
    xe, dest_e, dest_p, kept, top_g, top_i = _dispatch_local(
        xt, gates, e, k, cap)

    g_tp = comm.axis_group(mesh, sh.tp_axes) if sh.tp > 1 else None
    with tnn.manual_axes(), tape.suppress():
        if sh.ep_mode:
            if cfg.sparse_mode == "dual":
                sk = pln.effective_slice_k(d, cfg.sparse_slice_k)
                xs = act.sparsify(xe, slice_k=sk)
                xr = act.SparseActivation(
                    values=_to_experts(xs.values, g_tp, sh.tp),
                    bitmap=_to_experts(xs.bitmap, g_tp, sh.tp),
                    slice_act=_to_experts(xs.slice_act.to(torch.uint8),
                                          g_tp, sh.tp).to(torch.bool),
                    slice_k=sk)
            else:
                xr = _to_experts(xe, g_tp, sh.tp)
            yr, st = _expert_ffn(w, xr, cfg, plans=ploc,
                                 collect_stats=collect)
            ye = _from_experts(yr, g_tp, sh.tp)
        else:
            ye, st = _expert_ffn(w, xe, cfg, plans=ploc,
                                 collect_stats=collect)
            ye = comm.all_reduce(ye, g_tp)

    y = _combine_local(ye, dest_e, dest_p, kept, top_g, e, x.dtype)
    aux = _aux_loss(gates, top_i, e)
    if dpc:
        g = comm.axis_group(mesh, dpc)
        aux = comm.all_reduce(aux, g) / dpn
        if not local:
            y = comm.all_gather(y.reshape(x_blk.shape), g, dim=0)
    y, aux = comm.scale_grad(y, 1 / rep), comm.scale_grad(aux, 1 / rep)
    if collect:
        # the mesh-total schedule: every rank's counted steps summed,
        # recorded outside the block
        st = _sum_steps(st, comm.axis_group(mesh, mesh.mesh_dim_names),
                        x.device)
        for name, sc in st.items():
            tape.record(name, sc, sc.sparse if cfg.sparse_use_kernel
                        else None)
    return y.reshape(b, s, d), aux
