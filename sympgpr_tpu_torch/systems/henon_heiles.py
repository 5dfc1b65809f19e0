"""Henon-Heiles system: event-detected Poincare sections (PyTorch port of
``sympgpr_tpu/systems/henon_heiles.py``).

Integrates z = (q1, q2, p1, p2) with ``dq/dt = w p, dp1/dt = -w1 q1 - 2
lam q1 q2, dp2/dt = -w2 q2 - lam (q1^2 - q2^2)`` by batched fixed-step RK4
and records the rising crossings of q1 = 0 (p1 > 0).  Each crossing is
localized by Newton on the fractional RK4 step theta in [0, dt] solving
``q1(rk4(z_prev, theta)) = 0`` (dq1/dtheta = w1 p1), which keeps full RK4
accuracy at the section point.

The JAX package polishes every orbit at every step inside its scan (static
shapes).  Here the time loop steps the RK4 alone and keeps the states
((n_steps + 1, B, 4) float64); the crossings are then found from the
states, the first ``max_cuts`` of each orbit chosen by a cumulative count
along time, and all of them polished at once.  The polish of a crossing
depends on its own state only, so the values are those of the scan, while
a step costs one RK4 step instead of a polish of every orbit.
"""

from __future__ import annotations

import dataclasses
import random as _pyrandom

import numpy as np
import torch

from sympgpr_tpu_torch.systems.halton import halton

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HenonConfig:
    """Constants of the reference's Henon-Heiles workload (w1 = w2 = 1)."""

    N: int = 55
    nm: int = 500
    Ntest: int = 37
    sig2_n: float = 1e-12
    lam: float = 1.0
    E_bound: float = 0.01
    w1: float = 1.0
    w2: float = 1.0
    dt: float = 0.01
    scale: float = 1e2  # section coordinates are scaled by 1e2


def rhs(z: Tensor, lam: float, w1: float, w2: float) -> Tensor:
    q1, q2, p1, p2 = z[..., 0], z[..., 1], z[..., 2], z[..., 3]
    return torch.stack(
        [
            w1 * p1,
            w2 * p2,
            -w1 * q1 - 2.0 * lam * q1 * q2,
            -w2 * q2 - lam * (q1**2 - q2**2),
        ],
        dim=-1,
    )


def _rk4(z: Tensor, dt: float, lam: float, w1: float, w2: float) -> Tensor:
    k1 = rhs(z, lam, w1, w2)
    k2 = rhs(z + 0.5 * dt * k1, lam, w1, w2)
    k3 = rhs(z + 0.5 * dt * k2, lam, w1, w2)
    k4 = rhs(z + dt * k3, lam, w1, w2)
    return z + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _rk4_scaled(z: Tensor, theta: Tensor, lam: float, w1: float,
                w2: float) -> Tensor:
    """RK4 step with a step size theta (K,) per state of z (K, 4)."""
    th = theta[..., None]
    k1 = rhs(z, lam, w1, w2)
    k2 = rhs(z + 0.5 * th * k1, lam, w1, w2)
    k3 = rhs(z + 0.5 * th * k2, lam, w1, w2)
    k4 = rhs(z + th * k3, lam, w1, w2)
    return z + (th / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _polish_crossing(z_prev: Tensor, dt: float, lam: float, w1: float,
                     w2: float, iters: int = 6):
    """Newton on the fractional step length: q1(rk4(z_prev, theta)) = 0,
    from the secant estimate, theta kept in [0, dt].  Returns (the state
    at the section (K, 4), theta (K,))."""
    q1a = z_prev[..., 0]
    q1b = _rk4(z_prev, dt, lam, w1, w2)[..., 0]
    theta = dt * q1a / (q1a - q1b)  # secant start
    theta = torch.clamp(torch.nan_to_num(theta, nan=0.5 * dt), 0.0, dt)
    for _ in range(iters):
        zt = _rk4_scaled(z_prev, theta, lam, w1, w2)
        f = zt[..., 0]
        fp = w1 * zt[..., 2]  # dq1/dtheta = w1 p1
        step = f / torch.where(torch.abs(fp) > 1e-30, fp,
                               torch.full_like(fp, 1e-30))
        theta = torch.clamp(theta - step, 0.0, dt)
    return _rk4_scaled(z_prev, theta, lam, w1, w2), theta


def integrate_sections(cfg: HenonConfig, z0: Tensor, n_steps: int,
                       max_cuts: int):
    """Integrate (B, 4) float64 states for ``n_steps`` steps of ``cfg.dt``;
    collect the first ``max_cuts`` rising q1 = 0 crossings of each orbit.

    Returns (cuts (max_cuts, B, 4), tcuts (max_cuts, B), counts (B,)), on
    the device of ``z0``.  Unfilled slots are NaN.
    """
    B = z0.shape[0]
    lam, w1, w2, dt = cfg.lam, cfg.w1, cfg.w2, cfg.dt
    z = z0
    states = [z]
    for _ in range(n_steps):
        z = _rk4(z, dt, lam, w1, w2)
        states.append(z)
    Z = torch.stack(states)  # (n_steps + 1, B, 4)

    q1 = Z[..., 0]
    crossed = (q1[:-1] < 0.0) & (q1[1:] >= 0.0)  # (n_steps, B)
    before = torch.cumsum(crossed, dim=0) - crossed.long()
    write = crossed & (before < max_cuts)
    t_idx, b_idx = torch.nonzero(write, as_tuple=True)
    z_cut, theta = _polish_crossing(Z[t_idx, b_idx], dt, lam, w1, w2)
    slot = before[t_idx, b_idx]

    cuts = torch.full((max_cuts, B, 4), torch.nan, dtype=z0.dtype,
                      device=z0.device)
    tcuts = torch.full((max_cuts, B), torch.nan, dtype=z0.dtype,
                       device=z0.device)
    cuts[slot, b_idx] = z_cut
    tcuts[slot, b_idx] = t_idx.to(z0.dtype) * dt + theta
    return cuts, tcuts, write.sum(dim=0)


def energy(z: Tensor, lam: float) -> Tensor:
    q1, q2, p1, p2 = z[..., 0], z[..., 1], z[..., 2], z[..., 3]
    return (
        0.5 * (p1**2 + p2**2)
        + 0.5 * (q1**2 + q2**2)
        + lam * (q1**2 * q2 - q2**3 / 3.0)
    )


def _ebound(q2, p2, lam):
    """Section-energy bound used to filter ICs."""
    return 0.5 * p2**2 + 0.5 * q2**2 - lam * q2**3 / 3.0


def _qdot(q2, p2, lam, E_bound):
    """p1 on the section from energy conservation."""
    return np.sqrt(2 * E_bound - p2**2 - q2**2 + lam * 2.0 / 3.0 * q2**3)


def training_ics(cfg: HenonConfig = HenonConfig()) -> np.ndarray:
    """Halton (q2, p2) in [-0.15, 0.15]^2 filtered by the energy bound,
    completed to (0, q2, p1, p2) on the section."""
    samples_all = halton(2 * cfg.N, 2) * 0.3 - 0.15
    keep = _ebound(samples_all[:, 0], samples_all[:, 1], cfg.lam) < cfg.E_bound
    samples = samples_all[keep][: cfg.N]
    q2, p2 = samples[:, 0], samples[:, 1]
    p1 = _qdot(q2, p2, cfg.lam, cfg.E_bound)
    return np.stack([np.zeros(len(q2)), q2, p1, p2], axis=1)


def test_ics(cfg: HenonConfig = HenonConfig()) -> np.ndarray:
    """Seeded samples of linspaces in [-0.1, 0.1], drawn with Python's
    ``random`` (another generator would give other ICs)."""
    rng = _pyrandom.Random()
    rng.seed(1)
    q0 = np.linspace(-0.1, 0.1, cfg.Ntest)
    q0 = np.array(rng.sample(list(q0), cfg.Ntest))
    rng2 = _pyrandom.Random()
    rng2.seed(0)
    p0 = np.linspace(-0.1, 0.1, cfg.Ntest)
    p0 = np.array(rng2.sample(list(p0), cfg.Ntest))
    p1 = _qdot(q0, p0, cfg.lam, cfg.E_bound)
    return np.stack([np.zeros(cfg.Ntest), q0, p1, p0], axis=1)


def section_pairs(cfg: HenonConfig, z0: np.ndarray, n_cuts: int,
                  device: torch.device | str):
    """First ``n_cuts`` section points per orbit in scaled coordinates
    (q2 * scale, p2 * scale): ((n_cuts, B, 2) with NaN where an orbit has
    fewer cuts, counts (B,)), float64 on ``device``."""
    # a cut every ~2 pi / w1; a generous margin on the step budget
    n_steps = int((n_cuts + 2) * 7.5 / cfg.dt)
    z0 = torch.as_tensor(np.asarray(z0), dtype=torch.float64, device=device)
    cuts, _, count = integrate_sections(cfg, z0, n_steps, n_cuts)
    return cuts[..., [1, 3]] * cfg.scale, count
