"""Pendulum system: data generation and reference integration (PyTorch
port of ``sympgpr_tpu/systems/pendulum.py``).

H = p^2/2 + U0 (1 - cos(q + pi)).  Training pairs come from integrating
the ODE for one map time T_map = dtsymp * Nm from Halton-sampled initial
conditions; the integrator is a batched fixed-step RK4 (all orbits in one
batch, a Python loop over steps), float64 on the given device.
``integrate_scipy``, the reference-parity integrator, is a test helper.
"""

from __future__ import annotations

import dataclasses
import math
import random as _pyrandom

import numpy as np
import torch

from sympgpr_tpu_torch.systems.halton import halton

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PendulumConfig:
    """Constants of the reference's implicit pendulum workload."""

    U0: float = 1.0
    N: int = 20
    Nm: int = 200
    nm: int = 1000
    dtsymp: float = 1e-3
    sig2_n: float = 1e-16
    Ntest: int = 15
    qmin: float = 0.0
    qmax: float = 2.0 * np.pi
    pmin: float = -3.0
    pmax: float = 3.0
    qminmap: float = np.pi - 2.8
    qmaxmap: float = np.pi + 1.5
    pminmap: float = -2.3
    pmaxmap: float = 1.8


def rhs(y: Tensor) -> Tensor:
    """(dq/dt, dp/dt) = (p, -sin(q + pi)) on the last axis."""
    return torch.stack([y[..., 1], -torch.sin(y[..., 0] + math.pi)], -1)


def integrate_rk4(q0: Tensor, p0: Tensor, t_final: float, n_steps: int,
                  save_every: int = 0) -> Tensor:
    """Batched fixed-step RK4.

    Returns the final states (B, 2), or the trajectory (n_saved + 1, B, 2)
    when ``save_every`` > 0 (every ``save_every``-th step, starting with
    the IC).
    """
    y = torch.stack([torch.atleast_1d(q0), torch.atleast_1d(p0)], -1)
    dt = t_final / n_steps
    if save_every > 0 and n_steps % save_every:
        raise ValueError(f"n_steps {n_steps} is no multiple of save_every "
                         f"{save_every}")
    saved = [y]
    for i in range(n_steps):
        k1 = rhs(y)
        k2 = rhs(y + 0.5 * dt * k1)
        k3 = rhs(y + 0.5 * dt * k2)
        k4 = rhs(y + dt * k3)
        y = y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        if save_every > 0 and (i + 1) % save_every == 0:
            saved.append(y)
    return torch.stack(saved) if save_every > 0 else y


def symplectic_euler(q0: Tensor, p0: Tensor, dt: float,
                     n_steps: int) -> tuple[Tensor, Tensor]:
    """The cost-matched comparator integrator: p first, then q.  Returns
    (n_steps + 1, B) trajectories."""
    q = torch.atleast_1d(q0)
    p = torch.atleast_1d(p0)
    qs, ps = [q], [p]
    for _ in range(n_steps):
        p = p - dt * torch.sin(q + math.pi)
        q = q + dt * p
        qs.append(q)
        ps.append(p)
    return torch.stack(qs), torch.stack(ps)


def training_data(cfg: PendulumConfig, device: torch.device | str):
    """Halton ICs -> one map time of RK4 (10x the reference's dtsymp grid)
    -> the mixed-variable training set, float64 tensors on ``device``.

    Returns X = (q, P), z = (p - P | Q - q), the aux set Xp = (q, p) with
    absolute targets zp = P, the raw (q, p, Q, P) and t_map.
    """
    s = torch.as_tensor(halton(cfg.N, 2), dtype=torch.float64, device=device)
    q = s[:, 0] * (cfg.qmax - cfg.qmin) + cfg.qmin
    p = s[:, 1] * (cfg.pmax - cfg.pmin) + cfg.pmin
    t_map = cfg.dtsymp * cfg.Nm
    yf = integrate_rk4(q, p, t_map, 10 * cfg.Nm)
    Q, P = yf[:, 0], yf[:, 1]
    return dict(X=torch.stack([q, P], 1), z=torch.cat([p - P, Q - q]),
                Xp=torch.stack([q, p], 1), zp=P, q=q, p=p, Q=Q, P=P,
                t_map=t_map)


def test_initial_conditions(cfg: PendulumConfig):
    """(q0, p0) test ICs as numpy arrays: seed-1 samples of linspaces drawn
    with Python's ``random``."""
    rng = _pyrandom.Random()
    rng.seed(1)
    q0 = np.linspace(cfg.qminmap, cfg.qmaxmap, cfg.Ntest)
    p0 = np.linspace(cfg.pminmap, cfg.pmaxmap, cfg.Ntest)
    q0 = np.array(rng.sample(list(q0), cfg.Ntest))
    p0 = np.array(rng.sample(list(p0), cfg.Ntest))
    return q0, p0


def integrate_scipy(q0, p0, t_eval, method: str = "LSODA") -> np.ndarray:
    """Reference-parity integrator (``solve_ivp``, rtol 1e-13, one orbit
    at a time on the host), for tests.  Returns (B, 2, T)."""
    from scipy.integrate import solve_ivp

    def dydt(t, y):
        return [y[1], -np.sin(y[0] + np.pi)]

    out = []
    for qq, pp in zip(np.atleast_1d(q0), np.atleast_1d(p0)):
        res = solve_ivp(dydt, [t_eval[0], t_eval[-1]], [qq, pp],
                        t_eval=t_eval, method=method, rtol=1e-13,
                        atol=1e-16)
        out.append(res.y)
    return np.array(out)
