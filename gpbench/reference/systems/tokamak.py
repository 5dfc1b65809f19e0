"""The tokamak field-line system, plain PyTorch, float64: the benchmark's
own copy of the field, the semi-implicit midpoint integrator that makes
the training pairs, the initial conditions of its orbits, and the loss
boundary.  A configuration names it with ``"system": "tokamak"``; its
``N``, ``nph``, ``r_scale``, ``momentum_scale`` and ``field`` are read
here.

A system module gives ``pairs(config, blocks, device)``,
``initial_conditions(config, box, u)``, ``lost(config, P, q)`` and
``near_boundary(config, P, q, tol)``.

Perturbed vector potential on circular flux surfaces,

  Ath = B0 (r^2/2 - r^3/(3 R0) cos th)
  Aph = -B0 iota0 (r^2/2 - r^4/(4 a^2)) (1 + eps cos(m th + n ph))

advanced in (pth, th) with ph as time by the midpoint rule; the minor
radius r(pth, th) comes from a fixed 20-iteration Newton, the midpoint
residual from 8 Newton iterations with its exact Jacobian and a 2x2
Cramer solve.  This is SympGPR's ``python/05_tokamak/SympGPR`` field
(``calc_fieldlines.py``) and the arithmetic of the program's integrator,
frozen here so that the yardstick does not move with the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

B0 = 1.0
IOTA0 = 1.0
A_MINOR = 0.5
R0 = 1.0
NEWTON_R = 20
NEWTON_STEP = 8


def halton(n: int, dim: int, start: int) -> np.ndarray:
    """(n, dim) unscrambled Halton points over the first primes, from
    index ``start`` (ghalton's sequence starts at 1)."""
    primes = (2, 3, 5, 7, 11, 13)[:dim]
    idx = np.arange(start, start + n, dtype=np.int64)
    out = np.zeros((n, dim))
    for d, b in enumerate(primes):
        i, f = idx.copy(), 1.0 / b
        while np.any(i > 0):
            out[:, d] += f * (i % b)
            i //= b
            f /= b
    return out


def Ath(r, th):
    return B0 * (r**2 / 2.0 - r**3 / (3.0 * R0) * torch.cos(th))


def compute_r(pth, th, rstart, iters: int = NEWTON_R):
    """Minor radius from pth = Ath(r, th) by a fixed-count Newton."""
    ct = torch.cos(th)
    r = rstart
    for _ in range(iters):
        y = pth - B0 * (r**2 / 2.0 - r**3 / (3.0 * R0) * ct)
        dy = -B0 * (r - r**2 / R0 * ct)
        r = r - y / dy
    return r


def _terms(field: dict, r, th, ph):
    """A_th,r, A_th,th, A_ph,r, A_ph,th at (r, th, ph)."""
    arg = field["m"] * th + field["n"] * ph
    pert = 1.0 + field["eps"] * torch.cos(arg)
    atr = B0 * (r - r**2 / R0 * torch.cos(th))
    att = B0 * r**3 * torch.sin(th) / (3.0 * R0)
    apr = -B0 * IOTA0 * (r - r**3 / A_MINOR**2) * pert
    apt = (B0 * IOTA0 * (r**2 / 2.0 - r**4 / (4.0 * A_MINOR**2))
           * field["m"] * field["eps"] * torch.sin(arg))
    return atr, att, apr, apt


def _residual(field: dict, dph: float, znew: Tensor, zold: Tensor,
              rlast: Tensor):
    mid = 0.5 * (zold[:, :2] + znew)
    ph = zold[:, 2] + 0.5 * dph
    r = compute_r(mid[:, 0], mid[:, 1], rlast)
    atr, att, apr, apt = _terms(field, r, mid[:, 1], ph)
    y1 = zold[:, 0] - znew[:, 0] + dph * (apt - apr * att / atr)
    y2 = zold[:, 1] - znew[:, 1] - dph * apr / atr
    return y1, y2, r


def _jacobian(field: dict, dph: float, znew: Tensor, zold: Tensor,
              r: Tensor):
    """d(y1, y2)/d(pth_new, th_new); r(pth, th) enters through
    dr/dpth = 1/A_th,r and dr/dth = -A_th,th/A_th,r, the midpoint adds 1/2."""
    mt = 0.5 * (zold[:, 1] + znew[:, 1])
    ph = zold[:, 2] + 0.5 * dph
    m, eps = field["m"], field["eps"]
    c, s = torch.cos(mt), torch.sin(mt)
    arg = m * mt + field["n"] * ph
    ca, sa = torch.cos(arg), torch.sin(arg)
    pert = 1.0 + eps * ca
    a2 = A_MINOR**2
    bi = B0 * IOTA0
    me = m * eps
    atr = B0 * (r - r**2 / R0 * c)
    att = B0 * r**3 * s / (3.0 * R0)
    apr = -bi * (r - r**3 / a2) * pert
    # partial derivatives in r and th
    atr_r, atr_t = B0 * (1.0 - 2.0 * r * c / R0), B0 * r**2 * s / R0
    att_r, att_t = B0 * r**2 * s / R0, B0 * r**3 * c / (3.0 * R0)
    apr_r = -bi * (1.0 - 3.0 * r**2 / a2) * pert
    apr_t = bi * (r - r**3 / a2) * me * sa
    apt_r = bi * (r - r**3 / a2) * me * sa
    apt_t = bi * (r**2 / 2.0 - r**4 / (4.0 * a2)) * m * me * ca
    r_p, r_t = 1.0 / atr, -att / atr

    def total(d_r, d_t):  # derivatives along pth and th
        return d_r * r_p, d_r * r_t + d_t

    atr_P, atr_T = total(atr_r, atr_t)
    att_P, att_T = total(att_r, att_t)
    apr_P, apr_T = total(apr_r, apr_t)
    apt_P, apt_T = total(apt_r, apt_t)

    def dg1(dapt, dapr, datt, datr):
        return (dapt - (dapr * att + apr * datt) / atr
                + apr * att * datr / atr**2)

    def dg2(dapr, datr):
        return dapr / atr - apr * datr / atr**2

    h = 0.5 * dph
    j00 = -1.0 + h * dg1(apt_P, apr_P, att_P, atr_P)
    j01 = h * dg1(apt_T, apr_T, att_T, atr_T)
    j10 = -h * dg2(apr_P, atr_P)
    j11 = -1.0 - h * dg2(apr_T, atr_T)
    return j00, j01, j10, j11


def timestep(field: dict, dph: float, z: Tensor, rlast: Tensor):
    """One midpoint step of a (B, 3) batch (pth, th, ph); returns the new
    (B, 3) state and the midpoint r (the next step's Newton start)."""
    znew = z[:, :2]
    for _ in range(NEWTON_STEP):
        y1, y2, r = _residual(field, dph, znew, z, rlast)
        j00, j01, j10, j11 = _jacobian(field, dph, znew, z, r)
        det = j00 * j11 - j01 * j10
        d0 = (y1 * j11 - y2 * j01) / det
        d1 = (j00 * y2 - j10 * y1) / det
        znew = znew - torch.stack([d0, d1], dim=-1)
    _, _, r_mid = _residual(field, dph, znew, z, rlast)
    return torch.cat([znew, (z[:, 2] + dph)[:, None]], dim=-1), r_mid


def integrate_points(cfg: dict, s: np.ndarray, device) -> dict[str, Tensor]:
    """One-turn map pairs of field lines from unit points ``s`` (n, >= 2):
    r = 0.1 + r_scale s0, th = 2 pi s1, ph = 0, integrated over ``nph``
    midpoint steps of 2 pi / nph.  Returns float64 (n,) tensors q, p, Q, P
    on ``device`` with p = pth * ``momentum_scale``."""
    f64 = dict(dtype=torch.float64, device=device)
    r0 = torch.as_tensor(s[:, 0] * cfg["r_scale"] + 0.1, **f64)
    th0 = torch.as_tensor(s[:, 1] * 2.0 * np.pi, **f64)
    z = torch.stack([Ath(r0, th0), th0, torch.zeros_like(r0)], dim=-1)
    z0, rl = z, r0
    dph = 2.0 * math.pi / cfg["nph"]
    for _ in range(cfg["nph"]):
        z, rl = timestep(cfg["field"], dph, z, rl)
    scale = cfg["momentum_scale"]
    return dict(q=z0[:, 1], p=z0[:, 0] * scale, Q=z[:, 1], P=z[:, 0] * scale)


def pairs(cfg: dict, blocks: list[int], device) -> list[dict[str, Tensor]]:
    """The training pairs of each Halton block (points 1 + block N ...
    (block + 1) N of the 3-d sequence; block 0 is the published set),
    integrated together in one batch: float64 (N,) tensors q, p, Q, P."""
    N = cfg["N"]
    pts = np.concatenate([halton(N, 3, 1 + b * N) for b in blocks])
    d = integrate_points(cfg, pts, device)
    return [{k: v[i * N:(i + 1) * N] for k, v in d.items()}
            for i in range(len(blocks))]


def initial_conditions(cfg: dict, box, u: Tensor):
    """Initial conditions (q0, p0) from uniform draws ``u`` (2, ...) in
    [0, 1): r and th uniform over the ``box`` [[r_lo, r_hi], [th_lo,
    th_hi]], q0 = th, p0 = Ath(r, th) * momentum_scale."""
    (r_lo, r_hi), (t_lo, t_hi) = box
    r = r_lo + (r_hi - r_lo) * u[0]
    th = t_lo + (t_hi - t_lo) * u[1]
    return th, Ath(r, th) * cfg["momentum_scale"]


def _radius(cfg: dict, P: Tensor, q: Tensor) -> Tensor:
    return compute_r(P / cfg["momentum_scale"], q, torch.full_like(P, 0.3))


def lost(cfg: dict, P: Tensor, q: Tensor) -> Tensor:
    """The loss boundary at angle q: r > a (the minor radius) or P < 0."""
    return (_radius(cfg, P, q) > A_MINOR) | (P < 0.0)


def near_boundary(cfg: dict, P: Tensor, q: Tensor, tol: float) -> Tensor:
    """Rows within ``tol`` of the loss boundary, in r or in P."""
    return ((_radius(cfg, P, q) - A_MINOR).abs() < tol) | (P.abs() < tol)
