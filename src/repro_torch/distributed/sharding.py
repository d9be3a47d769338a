"""Logical-axis → mesh sharding policies per shape kind: the JAX
package's ``distributed/sharding.py`` on ``torch.distributed``.

Mesh axes: ("data", "model") single-pod 16×16, ("pod", "data", "model")
multi-pod 2×16×16.  Policies:

* train    — FSDP on data(+pod) for params/optimizer state (embed dim),
             TP on model (heads / ffn / experts), batch on data(+pod).
* prefill  — same layout minus the optimizer.
* decode   — 2-D weight sharding (weight-gathered serving), KV cache:
             batch on data(+pod), kv-heads on model.
* long     — batch=1: KV sequence on data, SSM state heads on model.

A mesh axis is never assigned twice in one spec: later logical axes that
map to an already-used mesh axis resolve to None (replicated on that
axis), so e.g. MoE expert weights ("experts","embed","mlp") shard as
(model, data, None).

A :class:`PartitionSpec` is a tuple with one entry per tensor dimension:
None (replicated), a mesh axis name, or a tuple of names (the dimension
split over their product, the first name outermost).  The parameter and
cache trees are the port's: a ``{parameter name: logical axes}`` dict, a
list with one cache per decoder layer.  :func:`local_slice` cuts a rank's
block of a whole tensor under a spec (what a ``shard_map`` in_spec hands
a block) and :func:`gather_slices` puts the blocks back together;
:func:`tree_shardings` maps specs to DTensor placements on a
``DeviceMesh``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import comm


class PartitionSpec(tuple):
    """``PartitionSpec("data", None)``: one entry per dimension (None, a
    mesh axis name or a tuple of names); equal to the plain tuple of its
    entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def _dp(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


def make_rules(kind: str, *, multi_pod: bool = False,
               decode_2d: bool = False) -> Dict[str, Any]:
    """The logical → mesh axis rules of a shape kind (train, prefill,
    decode, long)."""
    dp = _dp(multi_pod)
    common = {
        # params
        "vocab": "model",
        "embed": dp,           # FSDP dim
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "layers": None,
        # activations
        "batch": dp,
        "seq": None,
        "seq_q": "model",      # attention fallback when heads ∤ model
        "tokens_flat": dp,     # MoE dispatch token dim
        "expert_cap": dp,      # MoE expert capacity dim
        "seq_res": "model",    # residual-stream sequence sharding (SP)
        # KV caches shard their sequence dim on model; batch stays on data
        "seq_kv": "model",
    }
    common["kv_batch"] = common["batch"]   # cache batch dim
    if kind in ("train", "prefill"):
        return common
    if kind == "decode":
        dec = dict(common)
        dec["kv_heads"] = None
        if decode_2d:
            # weights 2-D sharded over (model, data): no per-token FSDP
            # weight gather; activations replicated on data, caches keep
            # batch on data
            dec.update({
                "embed": None,
                "mlp": ("model", "data"),
                "experts": "model",
                "heads": "model",
                "head_dim": "data",
                "ssm_inner": ("model", "data"),
                "vocab": ("model", "data"),
                "batch": None,
                "kv_batch": dp,
            })
        return dec
    if kind == "long":
        # batch=1: nothing to shard on data except the KV sequence
        long = dict(common)
        long["batch"] = None
        long["kv_batch"] = None
        long["seq_kv"] = dp
        long["kv_heads"] = None
        return long
    raise ValueError(kind)


def entry_axes(m) -> Tuple[str, ...]:
    """A rule's or a spec entry's mesh axes as a tuple (None → ())."""
    if m is None:
        return ()
    return tuple(m) if isinstance(m, (tuple, list)) else (m,)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names, in the order of its entries."""
    return tuple(a for e in spec for a in entry_axes(e))


def _entry(parts: Tuple[str, ...]):
    return None if not parts else parts[0] if len(parts) == 1 else parts


def spec_from_axes(axes: Sequence[Optional[str]],
                   rules: Dict[str, Any],
                   shape: Optional[Sequence[int]] = None,
                   axis_sizes: Optional[Dict[str, int]] = None
                   ) -> PartitionSpec:
    """Resolve logical axes → PartitionSpec.

    * a mesh axis is used at most once per spec (later dims replicate);
    * if ``shape``/``axis_sizes`` are given, mesh axes that do not divide
      the dim evenly are dropped from the assignment (a block must be
      whole: kv_heads=8 over model=16 resolves to replicated).
    """
    used = set()
    out = []
    for i, a in enumerate(axes):
        parts = entry_axes(rules.get(a) if a is not None else None)
        if not parts:
            out.append(None)
            continue
        parts = tuple(p for p in parts if p not in used)
        if shape is not None and axis_sizes is not None:
            parts = _best_divisible(parts, shape[i], axis_sizes)
        used.update(parts)
        out.append(_entry(parts))
    return PartitionSpec(*out)


def _best_divisible(parts, dim: int, sizes) -> tuple:
    """Largest contiguous sub-tuple of mesh axes whose product divides
    ``dim`` (e.g. batch=16 on ("pod","data")=2×16 → ("data",))."""
    best, best_prod = (), 1
    n = len(parts)
    for i in range(n):
        prod = 1
        for j in range(i, n):
            prod *= sizes.get(parts[j], 1)
            if dim % prod == 0 and prod > best_prod:
                best, best_prod = parts[i:j + 1], prod
    return tuple(best)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def _map_tree(fn, tree, *others):
    """``fn`` over the axes leaves of a tree of dicts, lists and tuples of
    axes (``others`` parallel trees whose leaves ride along)."""
    if _is_axes(tree):
        return fn(tree, *others)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, *(o[i] for o in others))
                for i, v in enumerate(tree)]
    raise TypeError(f"not an axes tree: {type(tree).__name__}")


def tree_pspecs(axes_tree, rules: Dict[str, Any]):
    """Tree of logical-axes tuples → tree of PartitionSpecs."""
    return _map_tree(lambda axes: spec_from_axes(axes, rules), axes_tree)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def tree_pspecs_shaped(axes_tree, abstract_tree, rules: Dict[str, Any],
                       mesh):
    """Shape-aware :func:`tree_pspecs` (divisibility): ``abstract_tree``
    parallel to ``axes_tree`` with tensors (meta tensors do) or shapes at
    its leaves."""
    sizes = mesh_sizes(mesh)
    return _map_tree(
        lambda axes, a: spec_from_axes(axes, rules, tuple(getattr(
            a, "shape", a)), sizes), axes_tree, abstract_tree)


def placements(mesh, spec: Sequence) -> List[Any]:
    """One DTensor placement per mesh dimension for ``spec``: ``Shard(d)``
    where tensor dim d is split over that mesh axis, ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        for name in entry_axes(entry):
            out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return out


def tree_shardings(mesh, pspec_tree):
    """Tree of PartitionSpecs → tree of DTensor placement lists."""
    if isinstance(pspec_tree, PartitionSpec):
        return placements(mesh, pspec_tree)
    if isinstance(pspec_tree, dict):
        return {k: tree_shardings(mesh, v) for k, v in pspec_tree.items()}
    if isinstance(pspec_tree, list):
        return [tree_shardings(mesh, v) for v in pspec_tree]
    return placements(mesh, pspec_tree)


# ---------------------------------------------------------------------------
# a rank's block of a tensor under a spec
# ---------------------------------------------------------------------------

def _coordinate(mesh) -> Dict[str, int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def block_range(dim: int, entry, mesh) -> Tuple[int, int]:
    """[start, stop) of this rank's block of a dimension of size ``dim``
    under one spec entry (the whole dimension for None)."""
    parts = entry_axes(entry)
    if not parts:
        return 0, dim
    sizes, coord = mesh_sizes(mesh), _coordinate(mesh)
    n, idx = 1, 0
    for p in parts:                     # the first name outermost
        n, idx = n * sizes[p], idx * sizes[p] + coord[p]
    if dim % n:
        raise ValueError(f"dimension {dim} does not split over {parts} "
                         f"({n} blocks)")
    size = dim // n
    return idx * size, (idx + 1) * size


def local_slice(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` (a view;
    a spec shorter than ``t``'s rank replicates the rest)."""
    for d, entry in enumerate(spec):
        lo, hi = block_range(t.shape[d], entry, mesh)
        if (lo, hi) != (0, t.shape[d]):
            t = t.narrow(d, lo, hi - lo)
    return t


def gather_slices(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The inverse of :func:`local_slice`: every rank's block under
    ``spec`` gathered into the whole tensor, on every rank (a collective
    over the mesh axes the spec names)."""
    for d, entry in enumerate(spec):
        parts = entry_axes(entry)
        if not parts:
            continue
        t = comm.all_gather(t, comm.axis_group(mesh, parts), dim=d)
        order = comm.group_order(mesh, parts)
        if order != sorted(order):
            # blocks arrive in rank order; put them in block order
            blocks = t.chunk(len(order), dim=d)
            t = torch.cat([blocks[order.index(i)]
                           for i in range(len(order))], dim=d)
    return t


# ---------------------------------------------------------------------------
# sparse-plan activity specs
# ---------------------------------------------------------------------------

def plan_spec_from_site(site, mesh_axis, *, ep_mode: bool,
                        k_shardable: bool = True) -> PartitionSpec:
    """PartitionSpec for one cached weight-plan activity, derived from
    its :class:`~repro_torch.sparse.site.OpSite` descriptor's logical
    axes.

    A weight plan's activity tensor is axis-parallel to the weight it
    plans — ``(…, S, N)`` for a ``(…, K, N)`` weight — so the site's
    logical axis names place the shard axis:

    * expert-parallel — shard wherever the site names ``"experts"``;
      S and N travel whole (slicing a plan along a fiber axis *is* the
      per-shard plan, ``plan.shard_plan``);
    * tensor-parallel — shard wherever the site names ``"mlp"``.  When
      that is the contraction position (second-to-last: the plan's S
      axis), the slice is legal only when shard boundaries align with
      slice boundaries (``plan.kplan_shardable``); callers pass
      ``k_shardable`` from that predicate and get the replicated spec
      (drop the cache) otherwise.
    """
    axes = site.axes
    if ep_mode:
        return PartitionSpec(*(mesh_axis if a == "experts" else None
                               for a in axes))
    spec = []
    for i, a in enumerate(axes):
        if a == "mlp":
            if i == len(axes) - 2 and not k_shardable:
                return PartitionSpec()
            spec.append(mesh_axis)
        else:
            spec.append(None)
    return PartitionSpec(*spec)


def plan_specs_from_sites(sites: Dict[str, Any], mesh_axis, *,
                          ep_mode: bool, k_shardable: bool = True
                          ) -> Dict[str, PartitionSpec]:
    """:func:`plan_spec_from_site` over a ``{weight key: OpSite}`` dict:
    the sharded MoE's blocks of the cached plan activities."""
    return {key: plan_spec_from_site(st, mesh_axis, ep_mode=ep_mode,
                                     k_shardable=k_shardable)
            for key, st in sites.items()}


def moe_plan_specs(ep_axis, *, ep_mode: bool,
                   down_k_shardable: bool) -> Dict[str, PartitionSpec]:
    """The MoE plan specs, from the expert FFN's OpSite descriptors."""
    from repro_torch.models.moe import moe_site
    return plan_specs_from_sites(
        {k: moe_site(k) for k in ("w_up", "w_gate", "w_down")},
        ep_axis, ep_mode=ep_mode, k_shardable=down_k_shardable)


# ---------------------------------------------------------------------------
# input / cache / optimizer specs
# ---------------------------------------------------------------------------

def input_pspecs(batch_specs: Dict[str, Any], rules: Dict[str, Any]
                 ) -> Dict[str, PartitionSpec]:
    """Specs of the model inputs (tokens/labels/the frontend's input),
    from tensors or meta tensors (``model_zoo.input_specs``)."""
    out = {}
    for name, sds in batch_specs.items():
        if name in ("tokens", "labels"):
            axes: Tuple[Optional[str], ...] = ("batch", None)
        else:  # frames / image_embeds / mel / images
            axes = ("batch", None, None)
        out[name] = spec_from_axes(axes[:len(sds.shape)], rules)
    return out


def cache_logical_axes(cfg) -> List[Any]:
    """Logical axes parallel to ``transformer.init_caches``: one entry per
    decoder layer, a KVCache (an attention or cross layer), an SSMState
    (a Mamba layer) or an EncDecCache of axes tuples (the JAX package's
    tree without its stacking axis ``"layers"``); a cache's ints
    (``pos``, ``window``) take ``()``."""
    from repro_torch.models.cache import EncDecCache, KVCache
    from repro_torch.models.ssm import SSMState

    def kv_axes():
        t = ("kv_batch", "seq_kv", "kv_heads", None)
        return KVCache(k=t, v=t, pos=(), window=(), k_scale=t, v_scale=t)

    def layer_axes(kind):
        if kind == "mamba":
            return SSMState(state=("kv_batch", "ssm_heads", None, None),
                            conv=("kv_batch", None, "ssm_inner"))
        return kv_axes()

    if cfg.is_encoder_decoder:
        return [EncDecCache(kv=kv_axes(), cross_kv=kv_axes())
                for _ in range(cfg.n_layers)]
    return [layer_axes(cfg.layer_kind(i % cfg.period))
            for i in range(cfg.n_layers)]


def _v_spec(spec, v):
    """A second moment's spec: a factored one's ``row`` under
    ``spec[:-1]`` and ``col`` under ``spec[:-2] + spec[-1:]`` (the JAX
    package's dry run builds them so)."""
    if isinstance(v, dict):
        parts = tuple(spec)
        return {"row": PartitionSpec(*parts[:-1]),
                "col": PartitionSpec(*parts[:-2], *parts[-1:])}
    return spec


def opt_state_pspecs(param_pspecs, v=None):
    """Adam m/v mirror the parameter shardings; step is replicated.  With
    ``v`` (an optimizer state's second moments), a factored entry's
    ``row``/``col`` specs (Adafactor)."""
    return {
        "m": param_pspecs,
        "v": (param_pspecs if v is None else
              {n: _v_spec(spec, v[n]) for n, spec in param_pspecs.items()}),
        "step": PartitionSpec(),
    }


# ---------------------------------------------------------------------------
# the train step's placement: every master a rank's block
# ---------------------------------------------------------------------------

def param_pspecs(model, cfg, rules: Dict[str, Any], mesh
                 ) -> Dict[str, PartitionSpec]:
    """The spec of every parameter of ``model`` (the port's names) under
    ``rules`` on ``mesh``: :func:`tree_pspecs_shaped` over the logical
    axes and whole shapes of ``model_zoo.abstract_params(cfg)``."""
    from repro_torch.models import model_zoo
    meta, axes = model_zoo.abstract_params(cfg)
    shapes = dict(meta.named_parameters())
    names = [n for n, _ in model.named_parameters()]
    if set(names) != set(shapes):
        raise ValueError("param_pspecs: the model's parameters are not "
                         f"those of {cfg.name}")
    return {n: spec_from_axes(axes[n], rules, tuple(shapes[n].shape),
                              mesh_sizes(mesh)) for n in names}


def batch_axes(rules: Dict[str, Any], mesh) -> Tuple[str, ...]:
    """The mesh axes that split the batch: the ``batch`` entry of
    :func:`input_pspecs`' specs, those of them the mesh has."""
    entry = spec_from_axes(("batch",), rules)[0]
    return tuple(a for a in entry_axes(entry) if a in mesh.mesh_dim_names)


def axes_size(mesh, axes: Sequence[str]) -> int:
    """The number of blocks over mesh ``axes`` (1 for none)."""
    sizes, n = mesh_sizes(mesh), 1
    for a in axes:
        n *= sizes[a]
    return n


def _module_and_attr(model: torch.nn.Module, name: str):
    mod_name, _, attr = name.rpartition(".")
    return (model.get_submodule(mod_name) if mod_name else model), attr


@torch.no_grad()
def shard_params_(model: torch.nn.Module, specs: Dict[str, PartitionSpec],
                  mesh, *, cfg=None, rules: Optional[Dict[str, Any]] = None
                  ) -> torch.nn.Module:
    """Cut every parameter of ``model`` in place to this rank's block under
    its spec (:func:`local_slice`, a copy: the whole tensor is dropped)
    and keep it trainable, the train step's float32 masters.  A MoE
    layer is marked for the sharded MoE on ``mesh`` under ``rules``
    (``moe.mark_sharded_``; its blocks enter the MoE resharded to its own
    specs), so a model with MoE layers needs ``cfg`` and ``rules``.
    Returns ``model``."""
    from repro_torch.models import moe as moem
    for name, p in list(model.named_parameters()):
        mod, attr = _module_and_attr(model, name)
        block = local_slice(p.detach(), specs[name], mesh).clone()
        setattr(mod, attr, torch.nn.Parameter(block, requires_grad=True))
    for module in model.modules():
        if isinstance(module, moem.MoE):
            if cfg is None or rules is None:
                raise ValueError("shard_params_: a model with MoE layers "
                                 "needs cfg and rules")
            moem.mark_sharded_(module, cfg, mesh, rules)
    return model


def reshard(t: torch.Tensor, src: Sequence, dst: Sequence, mesh
            ) -> torch.Tensor:
    """This rank's block under spec ``dst`` of the tensor whose block under
    ``src`` is ``t``: each dimension whose entries differ gathered over
    ``src``'s axes, then cut by ``dst``'s (no collective where they
    agree).  A tensor alike on the ranks that ``dst`` replicates
    comes back to ``src`` by the same call the other way."""
    ndim = t.ndim
    src = tuple(src) + (None,) * (ndim - len(src))
    dst = tuple(dst) + (None,) * (ndim - len(dst))
    for d in range(ndim):
        if src[d] == dst[d]:
            continue
        spec = [None] * ndim
        spec[d] = src[d]
        t = gather_slices(t, spec, mesh)
        spec[d] = dst[d]
        t = local_slice(t, spec, mesh)
    return t
