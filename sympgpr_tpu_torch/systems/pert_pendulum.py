"""Perturbed pendulum: stroboscopic Poincare map data (PyTorch port of
``sympgpr_tpu/systems/pert_pendulum.py``).

The time-periodic perturbed pendulum ``xdot = e (0.3 x sin 2t + 0.7 x sin
3t) + y``, ``ydot = -e (0.3 y sin 2t + 0.7 y sin 3t) - om^2 sin x`` (e =
0.5, om = 0.5) is mapped over one 2 pi period by fixed-step RK4 (1500
steps for training, 100 for the test reference), from initial conditions
Halton-sampled inside a disc.  All samples advance as one float64 batch on
the given device; the time loop is a Python loop, and the perturbation's
time factor is formed on the host once per stage.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sympgpr_tpu_torch.systems.halton import halton

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PertPendulumConfig:
    """Constants of the reference's perturbed-pendulum workload."""

    e: float = 0.5
    om: float = 0.5
    N: int = 55
    nm: int = 100
    radius: float = 0.9
    rk_steps_train: int = 1500
    rk_steps_test: int = 100
    sig2_n: float = 1e-12
    nics: int = 20

    @property
    def Ntest(self) -> int:
        return self.nics + self.nics // 2


def zdot(t: float, z: Tensor, e: float, om: float) -> Tensor:
    """(xdot, ydot) at time ``t`` (a Python float) for states z (..., 2)."""
    x, y = z[..., 0], z[..., 1]
    c = e * (0.3 * math.sin(2 * t) + 0.7 * math.sin(3 * t))
    return torch.stack([c * x + y, -c * y - om**2 * torch.sin(x)], dim=-1)


def rk_pmap(z: Tensor, e: float, om: float, n_rk_steps: int) -> Tensor:
    """One stroboscopic period of RK4 (t = i dphi at step i). z: (B, 2) ->
    (B, 2)."""
    dphi = 2.0 * np.pi / n_rk_steps
    for i in range(n_rk_steps):
        t = i * dphi
        k1 = zdot(t, z, e, om)
        k2 = zdot(t + 0.5 * dphi, z + 0.5 * dphi * k1, e, om)
        k3 = zdot(t + 0.5 * dphi, z + 0.5 * dphi * k2, e, om)
        k4 = zdot(t + dphi, z + dphi * k3, e, om)
        z = z + (dphi / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return z


def gen_samples_circle(origin, radius, n_samples) -> np.ndarray:
    """Halton disc sampling (Burby et al. 2020): (n_samples, 2)."""
    s_radius = 0.5 * radius**2
    samp = halton(n_samples, 2) * np.array([s_radius, 2 * np.pi])
    s, theta = samp[:, 0], samp[:, 1]
    x = origin[0] + np.sqrt(2 * s) * np.cos(theta)
    y = origin[1] + np.sqrt(2 * s) * np.sin(theta)
    return np.stack([x, y], axis=1)


def training_data(cfg: PertPendulumConfig, device: torch.device | str):
    """Disc ICs -> one stroboscopic map -> the pairs whose image stays in
    the disc -> q shifted by pi; float64 tensors on ``device``.

    Returns X = (q, P), z = (p - P | Q - q), the aux set Xp = (q, p) with
    absolute targets zp = P, the raw (q, p, Q, P) and ``n_data``.
    """
    data_raw = torch.as_tensor(
        gen_samples_circle([0.0, 0.0], cfg.radius, cfg.N),
        dtype=torch.float64, device=device)
    labels_raw = rk_pmap(data_raw, cfg.e, cfg.om, cfg.rk_steps_train)
    rr = labels_raw[:, 0] ** 2 + labels_raw[:, 1] ** 2
    keep = rr <= cfg.radius**2
    data, labels = data_raw[keep], labels_raw[keep]

    q = data[:, 0] + np.pi
    p = data[:, 1]
    Q = labels[:, 0] + np.pi
    P = labels[:, 1]
    return dict(X=torch.stack([q, P], 1), z=torch.cat([p - P, Q - q]),
                Xp=torch.stack([q, p], 1), zp=P, q=q, p=p, Q=Q, P=P,
                n_data=int(keep.sum()))


def test_initial_conditions(cfg: PertPendulumConfig):
    """Deterministic line ICs shifted by pi, as numpy arrays (q0, p0)."""
    nics = cfg.nics
    xic = np.linspace(0.05, 0.7, nics)
    yic = np.zeros(nics)
    yic2 = np.linspace(0.3, 0.6, nics // 2)
    xic2 = np.zeros(nics // 2)
    qs = np.concatenate([xic, xic2]) + np.pi
    ps = np.concatenate([yic, yic2])
    return qs, ps


def reference_orbits(cfg: PertPendulumConfig, q0: Tensor, p0: Tensor,
                     nm: int) -> tuple[Tensor, Tensor]:
    """nm rows of the true stroboscopic map (q pi-shifted, as q0), each
    period of ``rk_steps_test`` RK4 steps: (q, p), each (nm, B)."""
    z = torch.stack([q0 - np.pi, p0], dim=-1)
    zs = [z]
    for _ in range(nm - 1):
        z = rk_pmap(z, cfg.e, cfg.om, cfg.rk_steps_test)
        zs.append(z)
    zs = torch.stack(zs)
    return zs[..., 0] + np.pi, zs[..., 1]
