"""The collectives of the sharded MoE and the sharded train step, and the
process groups they run in.

``all_to_all`` (equal splits along dim 0), ``all_gather`` (blocks
concatenated along a dim) and ``all_reduce`` (a sum, or a max): each is
the ``torch.distributed`` call on the tensor as it is, in any backend,
and each carries a gradient, as the JAX package's ``jax.lax`` collectives
do inside ``shard_map``: the backward of ``all_gather`` sums the
cotangents over the group and keeps this rank's block (a reduce-scatter),
that of ``all_to_all`` is the ``all_to_all`` back, and that of a summing
``all_reduce`` is the same sum of the cotangents.  :func:`sum_grad` and
:func:`scale_grad` are the identity forward and act on the gradient
only: the two halves of ``shard_map``'s transpose for a value that is
replicated over some mesh axes.  A group of one rank moves nothing.
:func:`axis_group` gives the group along any set of a ``DeviceMesh``'s
axes, and :func:`group_order` the order of its blocks, both from the
mesh's rank layout (:func:`mesh_layout`), read once a mesh.
"""
from __future__ import annotations

import weakref
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _single(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    t = t.movedim(dim, 0).contiguous()
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],
                       *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out.movedim(0, dim)


def _all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the group of every rank's ``t``, this rank's block of
    it along ``dim``: an ``all_reduce`` and a slice, which any backend
    runs (gloo has no ``reduce_scatter_tensor``)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    return _all_reduce(t, group).chunk(n, dim=dim)[me].contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_to_all(ct, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, ct):
        return _reduce_scatter(ct, ctx.group, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, factor):
        ctx.factor = factor
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.factor, None


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Block j of ``t`` along dim 0 (of group-size equal blocks) to rank
    j; the result holds the blocks received, in rank order."""
    if _single(group):
        return t
    return _AllToAll.apply(t, group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    if _single(group):
        return t
    return _AllGather.apply(t, group, dim)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``) or the largest (``"max"``, no gradient) of
    every rank's ``t``, a new tensor."""
    if _single(group):
        return t
    if op == "sum":
        return _AllReduce.apply(t, group)
    return _all_reduce(t.detach(), group, op)


def sum_grad(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself; its gradient summed over ``group``: what
    ``shard_map``'s transpose does for an input whose spec does not name
    the group's axes (each rank's share of a replicated value's
    gradient, made whole on every rank)."""
    if _single(group) or not t.requires_grad:
        return t
    return _SumGrad.apply(t, group)


def scale_grad(t: torch.Tensor, factor: float) -> torch.Tensor:
    """``t`` itself; its gradient times ``factor``: 1 / n for an output
    that the n ranks of some mesh axes compute alike, so that their
    backwards, summed, count its cotangent once (``shard_map``'s
    transpose divides a replicated output's cotangent so)."""
    if factor == 1 or not t.requires_grad:
        return t
    return _ScaleGrad.apply(t, factor)


_GROUPS: Dict[tuple, object] = {}
_LAYOUTS: Dict[int, tuple] = {}


def mesh_layout(mesh) -> Tuple[tuple, tuple, tuple]:
    """(the mesh's ranks in row-major order, its shape, its axis names),
    read from ``mesh.mesh`` (tensor ops) on a mesh's first call and kept:
    later calls run no tensor op, so they work under a fake-tensor mode,
    where reading ``mesh.mesh`` fails (the dry run's trace;
    ``launch.mesh`` reads each mesh it makes at once)."""
    hit = _LAYOUTS.get(id(mesh))
    if hit is None or hit[0]() is not mesh:
        ranks = np.array(mesh.mesh.tolist())
        hit = (weakref.ref(mesh), (tuple(ranks.reshape(-1).tolist()),
                                   tuple(ranks.shape),
                                   tuple(mesh.mesh_dim_names)))
        _LAYOUTS[id(mesh)] = hit
    return hit[1]


def axis_group(mesh, axes: Sequence[str]):
    """The process group of the ranks that share this rank's coordinates
    on every mesh axis except ``axes``.  Its ranks run in global-rank
    order (``new_group`` sorts them), which is the order of their
    coordinates on ``axes`` when ``axes`` follow the mesh's own order
    (:func:`group_order` gives it otherwise).  Every rank creates every
    such group on first use, in the same order, as ``new_group``
    requires; later calls return the cached group."""
    axes = tuple(axes)
    ranks, shape, names = mesh_layout(mesh)
    key = (ranks, shape, names, axes)
    if key not in _GROUPS:
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(shape)) if d not in dims]
        width = 1
        for d in dims:
            width *= shape[d]
        rows = (np.array(ranks).reshape(shape).transpose(*rest, *dims)
                .reshape(-1, width).tolist())
        me = dist.get_rank()
        mine = None
        for row in rows:
            g = dist.new_group(row, backend=dist.get_backend())
            if me in row:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


def forget_groups() -> None:
    """Drop the cached groups (the process group they belong to was
    destroyed)."""
    _GROUPS.clear()


def group_order(mesh, axes: Sequence[str]) -> list:
    """For each rank of ``axis_group(mesh, axes)``, in group order, its
    block index over ``axes`` (the first outermost)."""
    group = axis_group(mesh, axes)
    ranks, shape, names = mesh_layout(mesh)
    sizes = dict(zip(names, shape))
    out = []
    for r in sorted(dist.get_process_group_ranks(group)):
        coord = dict(zip(names, np.unravel_index(ranks.index(r), shape)))
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + int(coord[a])
        out.append(idx)
    return out
