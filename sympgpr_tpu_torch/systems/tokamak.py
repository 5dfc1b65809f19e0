"""Tokamak field-line system (PyTorch port of
``sympgpr_tpu/systems/tokamak.py``).

Perturbed vector potential on circular flux surfaces,

  Ath = B0 (r^2/2 - r^3/(3 R0) cos th)
  Aph = -B0 iota0 (r^2/2 - r^4/(4 a^2)) (1 + eps cos(m th + n ph + phase))

with a semi-implicit midpoint field-line stepper in (pth, th, ph) and the
minor radius r(pth, th) from a fixed 20-iteration Newton.  All particles
advance together as one batch; the time loop is a Python loop.

The midpoint step solves its 2-D residual by Newton with the exact
Jacobian written out by hand (implicit differentiation of r(pth, th));
``tests/test_torch_tokamak.py`` holds it against ``torch.func.jacfwd`` of
the residual, which is what the JAX package uses.
"""

from __future__ import annotations

import dataclasses
import math
import random as _pyrandom

import numpy as np
import torch

from sympgpr_tpu_torch.systems.halton import halton

Tensor = torch.Tensor

B0 = 1.0
IOTA0 = 1.0  # constant part of rotational transform
A_MINOR = 0.5  # (equivalent) minor radius
R0 = 1.0  # (equivalent) major radius


@dataclasses.dataclass(frozen=True)
class TokamakField:
    """Perturbation parameters."""

    eps: float = 0.001
    m: int = -3
    n: int = 2
    phase: float = 0.0


def Ath(r, th, ph):
    return B0 * (r**2 / 2.0 - r**3 / (3.0 * R0) * torch.cos(th))


def dAthdr(r, th, ph):
    return B0 * (r - r**2 / R0 * torch.cos(th))


def dAthdth(r, th, ph):
    return B0 * r**3 * torch.sin(th) / (3.0 * R0)


def _pert_arg(field: TokamakField, th, ph):
    return field.m * th + field.n * ph + field.phase


def Aph(field: TokamakField, r, th, ph):
    pert = 1.0 + field.eps * torch.cos(_pert_arg(field, th, ph))
    return -B0 * IOTA0 * (r**2 / 2.0 - r**4 / (4.0 * A_MINOR**2)) * pert


def dAphdr(field: TokamakField, r, th, ph):
    pert = 1.0 + field.eps * torch.cos(_pert_arg(field, th, ph))
    return -B0 * IOTA0 * (r - r**3 / A_MINOR**2) * pert


def dAphdth(field: TokamakField, r, th, ph):
    return (
        B0
        * IOTA0
        * (r**2 / 2.0 - r**4 / (4.0 * A_MINOR**2))
        * field.m
        * field.eps
        * torch.sin(_pert_arg(field, th, ph))
    )


def compute_r(pth, th, ph, rstart, iters: int = 20):
    """Minor radius from pth = Ath(r, th): fixed 20-iteration Newton.

    cos(th) is the same in every iteration and is evaluated once; the
    arithmetic is otherwise that of ``Ath``/``dAthdr``.
    """
    ct = torch.cos(th)
    r = rstart
    for _ in range(iters):
        y = pth - B0 * (r**2 / 2.0 - r**3 / (3.0 * R0) * ct)
        dy = -B0 * (r - r**2 / R0 * ct)
        r = r - y / dy
    return r


def _tstep_residual(field: TokamakField, dph: float, znew: Tensor,
                    zold: Tensor, rlast: Tensor):
    """Midpoint residual of the field-line step.

    znew: (B, 2) = (pth, th) candidates; zold: (B, 3) = (pth, th, ph).
    Returns ((B, 2) residual, (B,) mid-point r).
    """
    mid = 0.5 * (zold[:, :2] + znew)
    ph = zold[:, 2] + 0.5 * dph
    r = compute_r(mid[:, 0], mid[:, 1], ph, rlast)
    dApdr = dAphdr(field, r, mid[:, 1], ph)
    dApdt = dAphdth(field, r, mid[:, 1], ph)
    dAtdr = dAthdr(r, mid[:, 1], ph)
    dAtdt = dAthdth(r, mid[:, 1], ph)
    y1 = zold[:, 0] - znew[:, 0] + dph * (dApdt - dApdr * dAtdt / dAtdr)
    y2 = zold[:, 1] - znew[:, 1] - dph * dApdr / dAtdr
    return torch.stack([y1, y2], dim=-1), r


def _tstep_jacobian(field: TokamakField, dph: float, znew: Tensor,
                    zold: Tensor, r: Tensor):
    """Exact (B, 2, 2) Jacobian of ``_tstep_residual`` w.r.t. znew.

    r(pth, th) is the root of pth = Ath(r, th), so dr/dpth = 1/Ath_r and
    dr/dth = -Ath_th/Ath_r; the midpoint contributes a factor 1/2.
    """
    mt = 0.5 * (zold[:, 1] + znew[:, 1])
    ph = zold[:, 2] + 0.5 * dph
    c, s = torch.cos(mt), torch.sin(mt)
    arg = _pert_arg(field, mt, ph)
    ca, sa = torch.cos(arg), torch.sin(arg)
    pert = 1.0 + field.eps * ca
    a2 = A_MINOR**2
    bi = B0 * IOTA0
    me = field.m * field.eps

    Atr = B0 * (r - r**2 / R0 * c)
    Att = B0 * r**3 * s / (3.0 * R0)
    Apr = -bi * (r - r**3 / a2) * pert
    Apt = bi * (r**2 / 2.0 - r**4 / (4.0 * a2)) * me * sa

    Atr_r = B0 * (1.0 - 2.0 * r * c / R0)
    Atr_t = B0 * r**2 * s / R0
    Att_r = B0 * r**2 * s / R0
    Att_t = B0 * r**3 * c / (3.0 * R0)
    Apr_r = -bi * (1.0 - 3.0 * r**2 / a2) * pert
    Apr_t = bi * (r - r**3 / a2) * me * sa
    Apt_r = bi * (r - r**3 / a2) * me * sa
    Apt_t = bi * (r**2 / 2.0 - r**4 / (4.0 * a2)) * field.m * me * ca

    r_p = 1.0 / Atr
    r_t = -Att / Atr

    def total(d_r, d_t):
        return d_r * r_p, d_r * r_t + d_t

    Atr_P, Atr_T = total(Atr_r, Atr_t)
    Att_P, Att_T = total(Att_r, Att_t)
    Apr_P, Apr_T = total(Apr_r, Apr_t)
    Apt_P, Apt_T = total(Apt_r, Apt_t)

    def dG1(dApt, dApr, dAtt, dAtr):
        return (dApt - (dApr * Att + Apr * dAtt) / Atr
                + Apr * Att * dAtr / Atr**2)

    def dG2(dApr, dAtr):
        return dApr / Atr - Apr * dAtr / Atr**2

    h = 0.5 * dph
    J00 = -1.0 + h * dG1(Apt_P, Apr_P, Att_P, Atr_P)
    J01 = h * dG1(Apt_T, Apr_T, Att_T, Atr_T)
    J10 = -h * dG2(Apr_P, Atr_P)
    J11 = -1.0 - h * dG2(Apr_T, Atr_T)
    return torch.stack([torch.stack([J00, J01], -1),
                        torch.stack([J10, J11], -1)], -2)


def timestep(field: TokamakField, dph: float, z: Tensor, rlast: Tensor,
             newton_iters: int = 8):
    """One semi-implicit midpoint step for a (B, 3) batch.

    Newton on the 2-D residual with the exact Jacobian and a closed-form
    2x2 (Cramer) solve.  Returns (z_new (B, 3), mid-point r (B,)).
    """
    znew = z[:, :2]
    for _ in range(newton_iters):
        f, r = _tstep_residual(field, dph, znew, z, rlast)
        J = _tstep_jacobian(field, dph, znew, z, r)
        det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        dx0 = (f[:, 0] * J[:, 1, 1] - f[:, 1] * J[:, 0, 1]) / det
        dx1 = (J[:, 0, 0] * f[:, 1] - J[:, 1, 0] * f[:, 0]) / det
        znew = znew - torch.stack([dx0, dx1], dim=-1)
    _, r_mid = _tstep_residual(field, dph, znew, z, rlast)
    return torch.cat([znew, (z[:, 2] + dph)[:, None]], dim=-1), r_mid


def integrate_fieldlines(
    field: TokamakField,
    pth0: Tensor,
    th0: Tensor,
    ph0: Tensor,
    nph: int,
    n_steps: int,
    rlast0: Tensor,
    save_every: int = 1,
) -> Tensor:
    """Batched field-line integration: (n_steps/save_every + 1, B, 3).

    dph = 2 pi / nph; all B particles advance in lock-step.
    """
    if n_steps % save_every:
        raise ValueError("n_steps must be a multiple of save_every")
    dph = 2.0 * math.pi / nph
    z = torch.stack([pth0, th0, ph0], dim=-1)
    rl = rlast0
    out = [z]
    for _ in range(n_steps // save_every):
        for _ in range(save_every):
            z, rl = timestep(field, dph, z, rl)
        out.append(z)
    return torch.stack(out)


def _fieldline_rhs(field: TokamakField, z: Tensor, ph, rlast: Tensor):
    """Explicit field-line ODE in (pth, th) with ph as time, for a (B, 2)
    batch: pth' = dAph/dth - dAph/dr dAth/dth / dAth/dr, th' = -dAph/dr /
    dAth/dr.  Returns ((B, 2) rhs, (B,) minor radius used)."""
    r = compute_r(z[:, 0], z[:, 1], ph, rlast)
    dApdr = dAphdr(field, r, z[:, 1], ph)
    dApdt = dAphdth(field, r, z[:, 1], ph)
    dAtdr = dAthdr(r, z[:, 1], ph)
    dAtdt = dAthdth(r, z[:, 1], ph)
    return torch.stack([dApdt - dApdr * dAtdt / dAtdr, -dApdr / dAtdr],
                       dim=-1), r


def integrate_fieldlines_rk4(
    field: TokamakField,
    pth0: Tensor,
    th0: Tensor,
    ph0: Tensor,
    nph: int,
    n_steps: int,
    rlast0: Tensor,
) -> Tensor:
    """Explicit RK4 cross-integrator of the same field-line flow as the
    semi-implicit midpoint ``timestep`` (an independent discretization: the
    two agreeing is a physics check).  The minor radius of a step's first
    stage seeds the Newton of the other three and of the next step.
    Batched over B particles; returns (n_steps + 1, B, 3)."""
    dph = 2.0 * math.pi / nph
    z = torch.stack([pth0, th0, ph0], dim=-1)
    rl = rlast0
    out = [z]
    for _ in range(n_steps):
        y, ph = z[:, :2], z[:, 2]
        k1, rl = _fieldline_rhs(field, y, ph, rl)
        k2, _ = _fieldline_rhs(field, y + 0.5 * dph * k1, ph + 0.5 * dph, rl)
        k3, _ = _fieldline_rhs(field, y + 0.5 * dph * k2, ph + 0.5 * dph, rl)
        k4, _ = _fieldline_rhs(field, y + dph * k3, ph + dph, rl)
        ynew = y + dph / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        z = torch.cat([ynew, (ph + dph)[:, None]], dim=-1)
        out.append(z)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Workload data generation


@dataclasses.dataclass(frozen=True)
class TokamakConfig:
    """Constants of the reference tokamak workload (nphmap > 1 is the Split
    layout)."""

    N: int = 80
    nm: int = 1000
    nturn: int = 2
    nph: int = 32
    nphmap: int = 1
    eps: float = 0.001
    mod_m: int = -3
    mod_n: int = 2
    sig2_n: float = 1e-14
    Ntest: int = 30
    r_scale: float = 0.26  # Halton box: r in [0.1, 0.1+r_scale]
    qminmap: float = 0.15
    qmaxmap: float = 0.25
    qminplt: float = 0.15
    qmaxplt: float = 0.31
    momentum_scale: float = 1e2  # P scaling

    @property
    def field(self) -> TokamakField:
        return TokamakField(eps=self.eps, m=self.mod_m, n=self.mod_n)


def _f64(x, device) -> Tensor:
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def training_data(cfg: TokamakConfig, device: torch.device | str):
    """Halton ICs -> one-turn (or per-split) map pairs in scaled variables.

    Returns per-split (N, nphmap) float64 tensors q, p, Q, P on ``device``
    with p = pth * 1e2, plus the full trajectory ``traj``.
    """
    s = halton(cfg.N, 3)
    r0 = _f64(s[:, 0] * cfg.r_scale + 0.1, device)
    th0 = _f64(s[:, 1] * 2.0 * np.pi, device)
    pth0 = Ath(r0, th0, 0.0)

    n_steps = cfg.nph * cfg.nturn
    traj = integrate_fieldlines(cfg.field, pth0, th0, torch.zeros_like(r0),
                                cfg.nph, n_steps, r0)

    ind = cfg.nph // cfg.nphmap
    M = cfg.nphmap
    scale = cfg.momentum_scale

    def sect(k, comp):
        return torch.stack([traj[(i + k) * ind, :, comp] for i in range(M)],
                           dim=1)

    return dict(q=sect(0, 1), p=sect(0, 0) * scale, Q=sect(1, 1),
                P=sect(1, 0) * scale, traj=traj)


def test_initial_conditions(cfg: TokamakConfig):
    """(r, th) test ICs for the GP rollout and the plotting/reference set,
    as numpy arrays: seed-1 samples of linspaces drawn with Python's
    ``random`` (another generator would give other ICs)."""

    def sample(qmin, qmax):
        rng = _pyrandom.Random()
        rng.seed(1)
        q0 = np.linspace(qmin, qmax, cfg.Ntest)
        p0 = np.linspace(0.0, 2.0 * np.pi, cfg.Ntest)
        q0 = np.array(rng.sample(list(q0), cfg.Ntest))
        p0 = np.array(rng.sample(list(p0), cfg.Ntest))
        return q0, p0  # (r, th)

    return sample(cfg.qminmap, cfg.qmaxmap), sample(cfg.qminplt, cfg.qmaxplt)


def ics_to_pth(r, th, device: torch.device | str):
    """Convert (r, th) ICs to canonical (pth, th) float64 tensors."""
    r, th = _f64(r, device), _f64(th, device)
    return Ath(r, th, 0.0), th


def reference_orbits(cfg: TokamakConfig, r0, th0, n_turns: int,
                     device: torch.device | str) -> Tensor:
    """Integrate reference test orbits; returns (n_steps+1, B, 3)."""
    pth0, th0 = ics_to_pth(r0, th0, device)
    return integrate_fieldlines(cfg.field, pth0, th0, torch.zeros_like(th0),
                                cfg.nph, cfg.nph * n_turns,
                                _f64(r0, device))


def field_energy(field: TokamakField, q: Tensor, p_scaled: Tensor,
                 ph: Tensor | float = 0.0, r_guess: float = 0.3) -> Tensor:
    """H = -Aph(r(pth, th), th, ph) with p_scaled = pth * 1e2."""
    pth = p_scaled * 1e-2
    r = compute_r(pth, q, ph, torch.full_like(pth, r_guess))
    return -Aph(field, r, q, ph)


def safety_factor(field: TokamakField, r0: float, n_turns: int = 10,
                  nph: int = 64, *, device: torch.device | str) -> float:
    """q = dphi / dtheta of the field line from (r0, th = 0, ph = 0) over
    ``n_turns`` turns of the midpoint integrator, a physics invariant of the
    cross-integrator checks."""
    r = _f64([r0], device)
    zero = torch.zeros_like(r)
    traj = integrate_fieldlines(field, Ath(r, zero, 0.0), zero, zero, nph,
                                nph * n_turns, r)
    dth = float(traj[-1, 0, 1] - traj[0, 0, 1])
    dph = float(traj[-1, 0, 2] - traj[0, 0, 2])
    return dph / dth
