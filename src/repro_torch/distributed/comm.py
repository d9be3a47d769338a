"""The collectives of the sharded MoE, and the process groups they run in.

``all_to_all`` (equal splits along dim 0), ``all_gather`` (blocks
concatenated along a dim) and ``all_reduce`` (a sum): each is the
``torch.distributed`` call on the tensor as it is, in any backend.  A
group of one rank moves nothing.  :func:`axis_group` gives the group
along any set of a ``DeviceMesh``'s axes, and :func:`group_order` the
order of its blocks.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist


def _single(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Block j of ``t`` along dim 0 (of group-size equal blocks) to rank
    j; the result holds the blocks received, in rank order."""
    if _single(group):
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    if _single(group):
        return t
    t = t.movedim(dim, 0).contiguous()
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],
                       *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out.movedim(0, dim)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` (a new tensor)."""
    if _single(group):
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


_GROUPS: Dict[tuple, object] = {}


def axis_group(mesh, axes: Sequence[str]):
    """The process group of the ranks that share this rank's coordinates
    on every mesh axis except ``axes``.  Its ranks run in global-rank
    order (``new_group`` sorts them), which is the order of their
    coordinates on ``axes`` when ``axes`` follow the mesh's own order
    (:func:`group_order` gives it otherwise).  Every rank creates every
    such group on first use, in the same order, as ``new_group``
    requires; later calls return the cached group."""
    axes = tuple(axes)
    ranks = mesh.mesh
    key = (tuple(ranks.flatten().tolist()), tuple(ranks.shape),
           tuple(mesh.mesh_dim_names), axes)
    if key not in _GROUPS:
        dims = [mesh.mesh_dim_names.index(a) for a in axes]
        rest = [d for d in range(ranks.ndim) if d not in dims]
        width = 1
        for d in dims:
            width *= ranks.shape[d]
        rows = ranks.permute(*rest, *dims).reshape(-1, width).tolist()
        me = dist.get_rank()
        mine = None
        for row in rows:
            g = dist.new_group(row, backend=dist.get_backend())
            if me in row:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


def group_order(mesh, axes: Sequence[str]) -> list:
    """For each rank of ``axis_group(mesh, axes)``, in group order, its
    block index over ``axes`` (the first outermost)."""
    group = axis_group(mesh, axes)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for r in sorted(dist.get_process_group_ranks(group)):
        coord = dict(zip(mesh.mesh_dim_names,
                         (mesh.mesh == r).nonzero()[0].tolist()))
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
        out.append(idx)
    return out
