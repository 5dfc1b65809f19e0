"""Orbit-data-parallel rollouts and restarts over ranks (PyTorch port of
``sympgpr_tpu/distributed/sharded.py``).

* ``dp`` axis: map-application orbits are embarrassingly parallel, so the
  orbit batch is cut into one contiguous shard a rank of the axis
  (JAX's ``P("dp")``) and each rank iterates its shard with no collective:
  ``apply_map_sharded`` (the plain path) and ``rollout_in_kernel_sharded``
  (the CUDA rollout kernel, one launch a rank).  Inputs are the whole
  batch on every rank; outputs are each rank's shard.
* restarts: ``fit_restarts_sharded`` deals Adam restarts over all ranks of
  the flattened mesh and gathers the best.

The replicated-K ``sharded_nll`` and its train step are not ported: the
never-replicated ``distributed/large.py`` path covers them.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from sympgpr_tpu_torch.distributed.init import (
    all_gather_rows,
    axis_group,
    flat_index,
)
from sympgpr_tpu_torch.gp.model import AuxGP, SympGP
from sympgpr_tpu_torch.maps.symplectic import LossFn, MapConfig, _map_step

Tensor = torch.Tensor


def mesh_shape(n: int) -> tuple[int, int]:
    """(dp, kp) of n ranks, factored as evenly as possible: kp the largest
    divisor of n not above sqrt(n) (8 -> (4, 2), 4 -> (2, 2), 2 -> (2, 1))."""
    kp = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
    return n // kp, kp


def make_mesh(device: torch.device | str = "cuda",
              axis_names=("dp", "kp")) -> DeviceMesh:
    """2-D mesh over every rank of the world: orbit-data-parallel x
    covariance-shard axes (``mesh_shape``)."""
    return init_device_mesh(torch.device(device).type,
                            mesh_shape(dist.get_world_size()),
                            mesh_dim_names=tuple(axis_names))


def _shard(mesh: DeviceMesh, axis: str, *xs: Tensor) -> list[Tensor]:
    """This rank's contiguous shard of each (B,) batch over ``axis``."""
    _, r, D = axis_group(mesh, axis)
    B = xs[0].shape[0]
    if B % D:
        raise ValueError(f"batch {B} must be a multiple of {D} ranks on "
                         f"axis {axis!r} (pad with NaN orbits)")
    s = B // D
    return [x[r * s:(r + 1) * s].contiguous() for x in xs]


def shard_orbits(mesh: DeviceMesh, q: Tensor, p: Tensor):
    """This rank's shard of an orbit batch over the ``dp`` axis."""
    return tuple(_shard(mesh, "dp", q, p))


def make_sharded_map_step(cfg: MapConfig, mesh: DeviceMesh,
                          loss_pre: LossFn | None = None):
    """One symplectic map step of the generic path on a rank's orbit shard.

    Returns step(sgp, aux, q, p) -> (Q, P) for this rank's shard
    (``shard_orbits``).  The step needs no collective: ``mesh`` is taken
    for the JAX package's signature."""

    def step(sgp: SympGP, aux: AuxGP | None, q: Tensor, p: Tensor):
        Q, P, _ = _map_step(sgp, aux, q, p, 0, cfg, loss_pre, None)
        return Q, P

    return step


def apply_map_sharded(mesh: DeviceMesh, sgp: SympGP, aux: AuxGP | None,
                      q0: Tensor, p0: Tensor, nm: int,
                      cfg: MapConfig = MapConfig(),
                      loss_pre: LossFn | None = None):
    """Full nm-step rollout with the orbit batch sharded over ``dp``.

    q0, p0: the whole (B,) batch on every rank; returns this rank's (nm,
    B/dp) shard of the (Q, P) trajectories (``maps.symplectic.apply_map``
    on its orbits)."""
    from sympgpr_tpu_torch.maps.symplectic import apply_map

    q, p = shard_orbits(mesh, q0, p0)
    traj = apply_map(sgp, aux, q, p, nm, cfg, loss_pre=loss_pre)
    return traj.q, traj.p


_ROLLOUT_BUILT = False


def _build_rollout_once() -> None:
    """Build the rollout kernel on local rank 0 (``LOCAL_RANK``, else the
    global rank) while the other ranks wait at a barrier, once a process:
    ``ops/_build.py`` writes its library atomically but holds no lock, so
    ranks building cold would each run nvcc."""
    global _ROLLOUT_BUILT
    if _ROLLOUT_BUILT:
        return
    from sympgpr_tpu_torch.ops import _build

    if int(os.environ.get("LOCAL_RANK", dist.get_rank())) == 0:
        _build.build("rollout_step")
    dist.barrier()
    _ROLLOUT_BUILT = True


def rollout_in_kernel_sharded(mesh: DeviceMesh, pm, q0: Tensor, p0: Tensor,
                              nm: int, *, axis: str = "dp", **kw):
    """The fused rollout with the orbit batch sharded over ``axis``: each
    rank runs ``ops/cuda_step.py::rollout_in_kernel`` on its shard (the
    CUDA kernel on CUDA tensors, ``rollout_reference`` on CPU ranks).

    Orbits never communicate, so the rollout scales over ranks with no
    collective.  The packed model is the same on every rank; the batch B
    must be a multiple of the axis' size (the kernel chooses its own
    geometry for any shard).  ``kw`` goes to ``rollout_in_kernel``.
    Returns this rank's (nm, B/D) shard of each trajectory.
    """
    from sympgpr_tpu_torch.ops.cuda_step import rollout_in_kernel

    q, p = _shard(mesh, axis, q0, p0)
    if q.device.type == "cuda":
        _build_rollout_once()
    return rollout_in_kernel(pm, q, p, nm, **kw)


def fit_restarts_sharded(objective: Callable[[Tensor], Tensor],
                         x0s: Sequence[Sequence[float]], mesh: DeviceMesh,
                         steps: int = 200, lr: float = 3e-2, *,
                         device: torch.device | str = "cuda"):
    """Multi-restart hyperparameter search, restarts dealt over all ranks
    of the flattened mesh (each rank runs its restarts' Adam chains, then
    one all-gather).

    ``objective``: float64 theta -> scalar on ``device``.  Each chain takes
    ``steps`` steps of ``gp/train.py::adam_update``; its value is the
    objective at its last step's start, as in the JAX package.  Returns
    (best_theta, best_val), the same on every rank.
    """
    from sympgpr_tpu_torch.gp.train import adam_update, value_and_grad

    x0s = torch.as_tensor(np.asarray(x0s, np.float64), device=device)
    r, n = flat_index(mesh)
    if x0s.shape[0] % n:
        raise ValueError(f"{x0s.shape[0]} restarts do not divide over {n} "
                         f"ranks")
    s = x0s.shape[0] // n
    thetas, vals = [], []
    for theta in x0s[r * s:(r + 1) * s]:
        mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
        for i in range(steps):
            v, g = value_and_grad(objective, theta)
            theta, mu, nu = adam_update(theta, g, mu, nu, i, lr)
        thetas.append(theta)
        vals.append(v)
    thetas, vals = all_gather_rows([torch.stack(thetas), torch.stack(vals)],
                                   mesh)
    best = int(torch.argmin(vals))
    return thetas[best].cpu().numpy(), float(vals[best])
