"""Quality metrics (PyTorch port of ``sympgpr_tpu/eval/metrics.py``):
energy oscillation ``Eosc = std(H)/mean(H)`` per orbit, geometric
distance of the first mapped point to the reference orbit, and the
pendulum's and the Henon-Heiles system's energies."""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def _nanstd(x: Tensor, dim: int) -> Tensor:
    """Population std ignoring NaNs (``jnp.nanstd`` with ddof=0)."""
    m = torch.nanmean(x, dim=dim, keepdim=True)
    return torch.sqrt(torch.nanmean((x - m) ** 2, dim=dim))


def energy_oscillation(H: Tensor, dim: int | None = None, *,
                       axis: int | None = None) -> Tensor:
    """std(H)/mean(H) along the time axis (0 by default); NaN (lost)
    samples ignored.  The axis is ``dim=`` (torch's name) or ``axis=``
    (the JAX package's), not both."""
    if dim is not None and axis is not None:
        raise TypeError("energy_oscillation takes dim= or axis=, not both")
    dim = axis if axis is not None else (dim or 0)
    return _nanstd(H, dim) / torch.nanmean(H, dim=dim)


def geometric_distance(q1: Tensor, p1: Tensor, q_ref: Tensor, p_ref: Tensor,
                       mod_q: float | None = None) -> tuple[Tensor, Tensor]:
    """Per-orbit MSE of the first mapped point vs the reference orbit.

    ``mod_q`` enables a minimum-image angle difference (off by default,
    as in the reference).  Returns (gd per orbit, std over orbits).
    """
    dq = q1 - q_ref
    if mod_q is not None:
        dq = dq - torch.round(dq / mod_q) * mod_q
    gd = 0.5 * (dq**2 + (p1 - p_ref) ** 2)
    return gd, torch.std(gd, correction=0)


def training_mse(z: Tensor, z_pred: Tensor) -> Tensor:
    return torch.mean((z - z_pred) ** 2)


def pendulum_energy(q: Tensor, p: Tensor, U0: float = 1.0) -> Tensor:
    """H = p^2/2 + U0 (1 - cos(q + pi))."""
    return p**2 / 2.0 + U0 * (1.0 - torch.cos(q + math.pi))


def henon_energy(x: Tensor, lam: float = 1.0) -> Tensor:
    """Henon-Heiles Hamiltonian on the full 4-D state (q1, q2, p1, p2)."""
    q1, q2, p1, p2 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return (
        0.5 * (p1**2 + p2**2)
        + 0.5 * (q1**2 + q2**2)
        + lam * (q1**2 * q2 - q2**3 / 3.0)
    )
