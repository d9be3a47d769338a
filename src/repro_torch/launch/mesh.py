"""Process groups and device meshes: the JAX package's
``launch/mesh.py`` on ``torch.distributed``.

Functions, not module-level state: importing this module touches no
process group.  :func:`init_distributed` joins the group that ``torchrun``
describes in the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) and picks the backend: NCCL when every rank on the host
has a card of its own, gloo on the CPU or when several ranks share one
card (NCCL refuses two ranks on one device).  The meshes are
``DeviceMesh`` es whose dimensions carry the sharding rules' axis names;
:func:`repro_torch.distributed.comm.axis_group` gives the process group
along any set of them, the group the sharded MoE's collectives run in.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import device as devmod
from repro_torch.distributed import comm


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(device=None) -> torch.device:
    """Join the process group of the ``torchrun`` environment variables
    and return this rank's device (``device=None``: the card).

    NCCL when the device is a card and the host has one for each of its
    ranks (``LOCAL_WORLD_SIZE``, default ``WORLD_SIZE``), each rank on
    ``cuda:LOCAL_RANK``; gloo otherwise: on the CPU, or with several ranks
    on one card, where every rank stays on the card and gloo takes its
    CUDA tensors as they are.  Rank 0 prints the choice.  Without ``WORLD_SIZE`` in the
    environment, or in a process already in a group, it joins nothing."""
    dev = devmod.resolve(device)
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return dev
    world = int(os.environ["WORLD_SIZE"])
    rnk = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rnk))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    why = "the CPU"
    backend = "gloo"
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if local_world <= n:
            backend, why = "nccl", f"a card for each of {local_world} ranks"
            dev = torch.device("cuda", local)
        else:
            why = f"{local_world} ranks share {n} card(s)"
            dev = torch.device("cuda", local % n)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rnk,
                            world_size=world)
    if rnk == 0:
        print(f"torch.distributed: {world} ranks over {backend} ({why}), "
              f"rank 0 on {dev}", flush=True)
    return dev


def destroy() -> None:
    """Leave the process group, forgetting the axis groups made in it."""
    comm.forget_groups()
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        # a one-rank group of this process alone
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the group has "
                         f"{dist.get_world_size()}")
    # the mesh only names the ranks: collectives run in comm.axis_group's
    # groups, in the default group's backend
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(kind, shape, mesh_dim_names=names)
    comm.mesh_layout(mesh)   # read now: a fake-tensor trace cannot
    return mesh


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 ("data", "model") or 2×16×16 ("pod", "data", "model");
    raises unless the group has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(model_parallel: int = 1):
    """(world / model_parallel, model_parallel) over ("data", "model"):
    every rank of the group (a one-rank group of this process when there
    is none)."""
    n = world_size()
    return _mesh((max(n // model_parallel, 1), model_parallel),
                 ("data", "model"))


def make_mesh(shape: Sequence[int], names: Sequence[str] = ("data",
                                                             "model")):
    """A mesh of any shape over the group's ranks (tests and smoke runs:
    (1, 4), (2, 2))."""
    return _mesh(tuple(shape), tuple(names))
