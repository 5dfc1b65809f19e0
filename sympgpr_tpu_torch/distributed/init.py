"""Process-group start-up, meshes and the collectives the port uses
(PyTorch port of ``sympgpr_tpu/distributed/init.py``).

JAX runs one process that sees every device and names mesh axes; PyTorch
runs one process per rank, each with its own device.  ``initialize``
starts the default process group: under ``python -m torch.distributed.run``
from the launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), otherwise as a world of one rank.  The
backend follows the device (NCCL for CUDA, gloo for the CPU) unless the
caller names one, and each rank uses ``cuda:LOCAL_RANK``.

A function of the port takes a ``DeviceMesh`` and an axis name where JAX
takes a ``Mesh`` and an axis: ``axis_group`` gives the axis' process group,
the rank on it (JAX's ``axis_index``) and its size (JAX's ``D``).  Every
rank calls every such function; the calls are collective.

Axis placement, as in the JAX package: ``kp`` (the block-cyclic
factorization) wants the fastest links, so keep it within a host (NVLink);
restart and chain parallelism has no traffic and may go across hosts;
``dp`` (orbit batches) has no collective at all.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

Tensor = torch.Tensor


def initialize(device: torch.device | str = "cuda", *,
               backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None,
               rank: int | None = None) -> torch.device:
    """Start the default process group unless it runs already; returns
    this rank's device: ``cuda`` without an index is ``cuda:LOCAL_RANK``
    (0 outside the launcher).

    With ``init_method`` (e.g. ``file://...`` or ``tcp://localhost:port``),
    ``world_size`` and ``rank`` the group starts there; else under the
    launcher from its environment; else as a world of one rank over an
    in-process store.  ``backend`` defaults to NCCL for a CUDA device and
    gloo for the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        if (world_size or 1) != 1:
            raise ValueError(
                f"world_size={world_size} needs an init_method or the "
                f"launcher's environment")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    return device


def shutdown() -> None:
    """Destroy the default process group if it runs."""
    if dist.is_initialized():
        dist.destroy_process_group()


def hybrid_mesh(ici_axis: str = "kp", dcn_axis: str = "chains",
                device: torch.device | str = "cuda") -> DeviceMesh:
    """2-D mesh of (hosts, ranks of a host): hosts on ``dcn_axis``, a
    host's ranks (``LOCAL_WORLD_SIZE``, all of them outside the launcher)
    on ``ici_axis``, the layout the embarrassingly parallel search axes
    want."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"world of {world} ranks is not hosts x {local}")
    return init_device_mesh(torch.device(device).type, (world // local, local),
                            mesh_dim_names=(dcn_axis, ici_axis))


def axis_group(mesh: DeviceMesh, axis: str):
    """(process group, this rank on it, its size) of a mesh axis."""
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def flat_index(mesh: DeviceMesh) -> tuple[int, int]:
    """(this rank's index, size) in the mesh flattened row-major, JAX's
    ``mesh.devices.reshape(-1)``; the mesh must span the world."""
    flat = mesh.mesh.flatten().tolist()
    if len(flat) != dist.get_world_size():
        raise ValueError(f"the mesh holds {len(flat)} of "
                         f"{dist.get_world_size()} ranks; a flattened mesh "
                         f"must span the world")
    return flat.index(dist.get_rank()), len(flat)


def all_gather(t: Tensor, group=None) -> Tensor:
    """(size, *t.shape): every rank's ``t`` in group-rank order."""
    out = t.new_empty((dist.get_world_size(group), *t.shape))
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
    return out


def all_gather_rows(tensors, mesh: DeviceMesh) -> list[Tensor]:
    """Every rank's tensors, which share a leading dim, concatenated along
    it in the order of the flattened mesh (``flat_index``), on every rank;
    one collective: they are packed as float64 rows (exact for the integer
    counts of a sampler), gathered, and unpacked to their dtypes."""
    tensors = list(tensors)
    rows = tensors[0].shape[0]
    packed = torch.cat([t.reshape(rows, -1).to(torch.float64)
                        for t in tensors], dim=1)
    by_rank = all_gather(packed)  # world ranks in order
    got = torch.cat([by_rank[r] for r in mesh.mesh.flatten().tolist()])
    out, c = [], 0
    for t in tensors:
        w = t[0].numel()
        out.append(got[:, c:c + w].to(t.dtype).reshape(-1, *t.shape[1:]))
        c += w
    return out


def broadcast_from(t: Tensor, owner: int, group) -> Tensor:
    """Broadcast ``t`` in place from the rank ``owner`` of ``group``."""
    dist.broadcast(t, src=dist.get_global_rank(group, owner), group=group)
    return t
