"""Chirikov standard map, exact iteration, batched (PyTorch port of
``sympgpr_tpu/systems/standard_map.py``).

J' = J + k sin(th), th' = th + J' for a batch of orbits; the time loop is
a Python loop over tensors, float64 on the given device.
"""

from __future__ import annotations

import dataclasses
import random as _pyrandom

import numpy as np
import torch

from sympgpr_tpu_torch.systems.halton import halton

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class StandardMapConfig:
    """Constants of the reference workload (k = 2, N = 20, nm = 100, 30 test
    orbits)."""

    k: float = 2.0
    N: int = 20
    nm: int = 100
    Ntest: int = 30
    sig2_n: float = 1e-12


def iterate(q0: Tensor, p0: Tensor, k: float,
            n_steps: int) -> tuple[Tensor, Tensor]:
    """(n_steps + 1, B) trajectories of the exact map (unwrapped)."""
    q = torch.atleast_1d(q0)
    p = torch.atleast_1d(p0)
    qs, ps = [q], [p]
    for _ in range(n_steps):
        p = p + k * torch.sin(q)
        q = q + p
        qs.append(q)
        ps.append(p)
    return torch.stack(qs), torch.stack(ps)


def training_data(cfg: StandardMapConfig, device: torch.device | str):
    """One exact map application from Halton ICs in [0, 2 pi)^2, float64
    tensors on ``device``: the mixed-variable set X = (q, P), z = (p - P |
    Q - q), the aux set Xp = (q, p) with delta targets zp = P - p, and the
    raw (q, p, Q, P)."""
    X0 = torch.as_tensor(halton(cfg.N, 2) * 2.0 * np.pi,
                         dtype=torch.float64, device=device)
    q, p = X0[:, 0], X0[:, 1]
    qs, ps = iterate(q, p, cfg.k, 1)
    Q, P = qs[1], ps[1]
    return dict(X=torch.stack([q, P], 1), z=torch.cat([p - P, Q - q]),
                Xp=torch.stack([q, p], 1), zp=P - p, q=q, p=p, Q=Q, P=P)


def test_initial_conditions(cfg: StandardMapConfig):
    """(q0, p0) test ICs as numpy arrays: seed-0 samples of linspaces over
    [0, 2 pi] drawn with Python's ``random`` (another generator would give
    other ICs)."""
    rng = _pyrandom.Random()
    rng.seed(0)
    q0 = np.linspace(0.0, 2.0 * np.pi, cfg.Ntest)
    p0 = np.linspace(0.0, 2.0 * np.pi, cfg.Ntest)
    q0 = np.array(rng.sample(list(q0), cfg.Ntest))
    p0 = np.array(rng.sample(list(p0), cfg.Ntest))
    return q0, p0
