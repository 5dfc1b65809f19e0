"""Factorized fast path for map application with product kernels (PyTorch
port of ``sympgpr_tpu/maps/fast_apply.py``).

For k(u, v) = A(dq) * B(dP) with B = exp(-dP^2 / (2 ly^2)) and
A = exp(-s(dq)), the q-side factors (A, s', s'') are invariant across the
Newton iterations of one map step, so they are folded once per step into

  pGP(P)       = sum_i (c0 + c1 dP) B(dP)
  d pGP / d P  = sum_i (c0 dP/ly^2 + c1 (dP^2/ly^2 - 1)) B(dP)
  qGP(P)       = sum_i (c2 dP + c3 (1/ly^2 - dP^2/ly^4)) B(dP)

with c0 = sig a0 (s'' - s'^2) A, c1 = -sig a1 s' A / ly^2,
c2 = -sig a0 s' A / ly^2, c3 = sig a1 A and dP = u_P - P.

This is also the plain version of the CUDA rollout kernel
(``ops/cuda_step.py::rollout_reference``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sympgpr_tpu_torch.gp.model import AuxGP, SympGP
from sympgpr_tpu_torch.maps.symplectic import (
    LossFn,
    MapConfig,
    Trajectory,
    _finish_step,
    _iterate,
)

Tensor = torch.Tensor

_FAST_KERNELS = ("per_se", "se_se", "per_se_freq")
_FAST_SUM_KERNELS = ("sum_per_se",)
# a sum kernel's q-side addend determines its A-factor set
_SUM_QSIDE = {"sum_per_se": "per_se"}


def supports(kernel_name: str) -> bool:
    return kernel_name in _FAST_KERNELS + _FAST_SUM_KERNELS


def _q_factors(name: str, d: Tensor, params: Tensor):
    """A(d), s'(d), s''(d) for the q-side factor A = exp(-s)."""
    lx = params[0]
    if name == "per_se":
        s = torch.sin(0.5 * d) ** 2 / (2.0 * lx**2)
        sp = torch.sin(d) / (4.0 * lx**2)
        spp = torch.cos(d) / (4.0 * lx**2)
    elif name == "se_se":
        s = d**2 / (2.0 * lx**2)
        sp = d / lx**2
        spp = torch.ones_like(d) / lx**2
    elif name == "per_se_freq":
        f = params[2]
        s = torch.sin(f * d) ** 2 / (2.0 * lx**2)
        sp = f * torch.sin(2.0 * f * d) / (2.0 * lx**2)
        spp = f**2 * torch.cos(2.0 * f * d) / lx**2
    else:
        raise ValueError(name)
    return torch.exp(-s), sp, spp


class StepCoeffs(NamedTuple):
    """Newton-invariant per-(orbit, train-point) coefficients."""

    c0: Tensor  # (B, N)
    c1: Tensor
    c2: Tensor
    c3: Tensor
    uP: Tensor  # (N,) train momenta
    ly: Tensor


def p_explicit_sum(sgp: SympGP, q: Tensor) -> Tensor:
    """pGP for a separable sum kernel; depends on q only."""
    n = sgp.n_train
    d = sgp.X[None, :, 0] - q[:, None]
    A, sp, spp = _q_factors(_SUM_QSIDE[sgp.kernel.name], d, sgp.params)
    a0 = sgp.alpha.reshape(2, n)[0]
    return sgp.sig * torch.sum(a0[None, :] * (spp - sp * sp) * A, dim=-1)


def q_update_sum(sgp: SympGP, P: Tensor) -> Tensor:
    """Delta q for a separable sum kernel; depends on P only."""
    n = sgp.n_train
    ly = sgp.params[1]
    dP = sgp.X[None, :, 1] - P[:, None]
    B = torch.exp(-(dP**2) / (2.0 * ly**2))
    a1 = sgp.alpha.reshape(2, n)[1]
    ily2 = 1.0 / ly**2
    return sgp.sig * torch.sum(
        a1[None, :] * (ily2 - dP**2 * ily2**2) * B, dim=-1)


def precompute_step(sgp: SympGP, q: Tensor) -> StepCoeffs:
    n = sgp.n_train
    params = sgp.params
    ly = params[1]
    d = sgp.X[:, 0][None, :] - q[:, None]  # (B, N), dq = u_q - v_q
    A, sp, spp = _q_factors(sgp.kernel.name, d, params)
    a = sgp.alpha.reshape(2, n)
    a0 = a[0][None, :]
    a1 = a[1][None, :]
    sig = sgp.sig
    c0 = sig * a0 * (spp - sp**2) * A
    c1 = -sig * a1 * sp * A / ly**2
    c2 = -sig * a0 * sp * A / ly**2
    c3 = sig * a1 * A
    return StepCoeffs(c0, c1, c2, c3, sgp.X[:, 1], ly)


def p_value_slope(co: StepCoeffs, P: Tensor):
    """(pGP, d pGP/dP) for the whole batch; one exp per pair."""
    dP = co.uP[None, :] - P[:, None]
    B = torch.exp(-(dP**2) / (2.0 * co.ly**2))
    ily2 = 1.0 / co.ly**2
    pGP = torch.sum((co.c0 + co.c1 * dP) * B, dim=-1)
    slope = torch.sum(
        (co.c0 * dP * ily2 + co.c1 * (dP**2 * ily2 - 1.0)) * B, dim=-1)
    return pGP, slope


def q_update(co: StepCoeffs, P: Tensor) -> Tensor:
    """qGP (= Delta q) at the solved P."""
    dP = co.uP[None, :] - P[:, None]
    B = torch.exp(-(dP**2) / (2.0 * co.ly**2))
    ily2 = 1.0 / co.ly**2
    return torch.sum((co.c2 * dP + co.c3 * (ily2 - dP**2 * ily2**2)) * B,
                     dim=-1)


def aux_guess(aux: AuxGP, q: Tensor, p: Tensor) -> Tensor:
    """Batched aux-GP posterior mean, factorized (one pass)."""
    params = aux.params
    ly = params[1]
    d = aux.X[None, :, 0] - q[:, None]
    A, _, _ = _q_factors(aux.kernel.name, d, params)
    dP = aux.X[None, :, 1] - p[:, None]
    Bf = torch.exp(-(dP**2) / (2.0 * ly**2))
    mean = aux.sig * torch.sum(aux.alpha[None, :] * A * Bf, dim=-1)
    return p + mean if aux.delta else mean


def newton_P(co: StepCoeffs, p: Tensor, P0: Tensor, tol: float,
             maxiter: int, fixed_iters: bool) -> Tensor:
    """Batched Newton on f(P) = pGP(P) - p + P.

    ``fixed_iters`` runs exactly ``maxiter`` iterations with no
    convergence test; otherwise converged and non-finite lanes are frozen
    and the loop ends when every lane is done (one host sync per
    iteration).
    """
    P = P0
    if fixed_iters:
        for _ in range(maxiter):
            f, fp = p_value_slope(co, P)
            Pn = P - (f - p + P) / (fp + 1.0)
            P = torch.where(torch.isfinite(Pn), Pn, P)
        return P

    done = ~torch.isfinite(P0)
    it = 0
    while it < maxiter and not bool(done.all()):
        f, fp = p_value_slope(co, P)
        step = (f - p + P) / (fp + 1.0)
        Pn = P - step
        bad = ~torch.isfinite(Pn)
        Pn = torch.where(done | bad, P, Pn)
        done = done | (torch.abs(step) < tol * (1.0 + torch.abs(Pn))) | bad
        P = Pn
        it += 1
    return P


def map_step(
    sgp: SympGP,
    aux: AuxGP | None,
    q: Tensor,
    p: Tensor,
    i: int,
    cfg: MapConfig,
    loss_pre: LossFn | None = None,
    loss_post: LossFn | None = None,
    fixed_iters: bool = False,
) -> tuple[Tensor, Tensor, Tensor]:
    """One step of the learned map from (q, p) at step index ``i``.

    Returns (Q, P, dP): the new point (P wrapped by ``mod_p``; NaN where
    an orbit is lost) and the unwrapped momentum increment.
    """
    is_sum = sgp.kernel.name in _FAST_SUM_KERNELS
    if is_sum:
        co = None
        P = p - p_explicit_sum(sgp, q)
    elif cfg.explicit:
        co = precompute_step(sgp, q)
        pGP, _ = p_value_slope(co, p)
        P = p - pGP
    else:
        co = precompute_step(sgp, q)
        P0 = aux_guess(aux, q, p)
        P = newton_P(co, p, P0, cfg.newton_tol, cfg.newton_maxiter,
                     fixed_iters)
    return _finish_step(
        q, p, P, i, cfg, loss_pre, loss_post,
        (lambda Pw: q_update_sum(sgp, Pw)) if is_sum
        else (lambda Pw: q_update(co, Pw)))


def _check_fast(sgp: SympGP, cfg: MapConfig) -> None:
    if not supports(sgp.kernel.name):
        raise ValueError(f"no fast path for kernel {sgp.kernel.name!r}")
    if sgp.kernel.name in _FAST_SUM_KERNELS and not cfg.explicit:
        raise ValueError("sum kernels imply the explicit map (Algorithm 2)")


def apply_map_fast(
    sgp: SympGP,
    aux: AuxGP | None,
    q0: Tensor,
    p0: Tensor,
    nm: int,
    cfg: MapConfig = MapConfig(),
    loss_pre: LossFn | None = None,
    loss_post: LossFn | None = None,
    fixed_iters: bool = False,
) -> Trajectory:
    """``apply_map`` for product and sum kernels, in the dtype and on the
    device of the inputs."""
    return apply_map_split_fast([sgp], [aux], q0, p0, nm, cfg, loss_pre,
                                loss_post, fixed_iters)


def apply_map_split_fast(
    sgps: list[SympGP],
    auxes: list[AuxGP | None],
    q0: Tensor,
    p0: Tensor,
    nm: int,
    cfg: MapConfig = MapConfig(),
    loss_pre: LossFn | None = None,
    loss_post: LossFn | None = None,
    fixed_iters: bool = False,
) -> Trajectory:
    """``apply_map_split`` on the fast path: step i (the one that makes row
    i + 1) applies sub-map ``i % len(sgps)``; the Split tokamak checks the
    loss boundary after the step (``loss_post``).  With one sub-map it is
    ``apply_map_fast``."""
    for sgp in sgps:
        _check_fast(sgp, cfg)
    M = len(sgps)
    return _iterate(
        lambda i, q, p: map_step(sgps[i % M], auxes[i % M], q, p, i, cfg,
                                 loss_pre, loss_post, fixed_iters),
        q0, p0, nm, cfg.track_pdiff)
