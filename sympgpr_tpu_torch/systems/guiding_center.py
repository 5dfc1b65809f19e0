"""Guiding-center phase-space machinery (PyTorch port of
``sympgpr_tpu/systems/guiding_center.py``).

Reference: ``python/05_tokamak/SympGPR/common.py:1-153`` (guiding-center
Hamiltonian ``H = m vpar^2/2 + mu B + qe Phie``, canonical momenta
``pth = m hth vpar + qe/c Ath`` / ``pph = m hph vpar + qe/c Aph``, hand-
propagated first and second derivative chains ``get_der`` / ``get_der2``
and scalar Newton iterations ``newton1`` / ``newton``), with the field
model of ``field_test.py:13-47`` (analytic ``Ath, Aph, hth, hph, B,
Phie`` on circular flux surfaces, ``B ~ B0 (1 - r/R0 cos th)``).

The field and the three phase-space functions (H, pth, vpar) are defined
once in closed form; every derivative comes from ``torch.func.jacfwd`` /
``torch.func.hessian``, and the ``*_batch`` versions map over a (B, 4)
stack with ``torch.func.vmap``.  ``newton_scalar`` is a lock-step masked
Newton over a batch, one host check of the stopping rule a step.  Work
runs on the device and in the dtype of the input tensors (numbers become
float64 tensors).

Known reference inaccuracy not replicated: ``get_der2`` never assigns
``d2Hdpphdz[3]`` (= d²H/dpph², ``common.py:96-117``) although the true value
is ``m (dvpar/dpph)^2 = 1/(m hph^2) != 0``; autodiff returns the true
value.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.func import hessian, jacfwd, vmap

Tensor = torch.Tensor

# Field constants (field_test.py:8-11)
B0 = 1.0  # magnetic field modulus normalization
IOTA0 = 1.0  # constant part of rotational transform
A_MINOR = 0.5  # (equivalent) minor radius
R0 = 1.0  # (equivalent) major radius

TAUB = 7800.0  # estimated bounce time (common.py:12)


@dataclasses.dataclass(frozen=True)
class GCParams:
    """Particle parameters (common.py:19-21)."""

    qe: float = 1.0  # charge
    m: float = 1.0  # mass
    c: float = 1.0  # speed of light
    mu: float = 1e-5  # magnetic moment


class FieldVals(NamedTuple):
    """Values of the model field at one (possibly batched) point."""

    Ath: Tensor
    Aph: Tensor
    hth: Tensor
    hph: Tensor
    B: Tensor
    Phie: Tensor


def _t(x) -> Tensor:
    return x if isinstance(x, Tensor) else torch.as_tensor(
        x, dtype=torch.float64)


def field_eval(r, th, ph) -> FieldVals:
    """Model tokamak field on circular flux surfaces (field_test.py:15-47).

    Values only: the reference's hand-written ``dAth/d2Ath/...`` arrays are
    replaced by autodiff of this function.
    """
    r, th = _t(r), _t(th)
    cth = torch.cos(th)
    zer = torch.zeros_like(r)
    Ath = B0 * (r**2 / 2.0 - r**3 / (3.0 * R0) * cth)
    Aph = -B0 * IOTA0 * (r**2 / 2.0 - r**4 / (4.0 * A_MINOR**2))
    hth = IOTA0 * (1.0 - r**2 / A_MINOR**2) * r**2 / R0
    hph = R0 + r * cth
    B = B0 * (1.0 - r / R0 * cth)
    Phie = zer
    return FieldVals(Ath, Aph, hth, hph, B, Phie)


def _vals(z: Tensor, p: GCParams) -> Tensor:
    """Stacked (H, pth, vpar) at phase-space point z = (r, th, ph, pph).

    Parallel velocity is recovered from the conserved toroidal momentum,
    ``vpar = (pph - qe/c Aph) / (m hph)`` (common.py:47-55, which sets
    m = 1).
    """
    f = field_eval(z[0], z[1], z[2])
    vpar = (z[3] - p.qe / p.c * f.Aph) / (p.m * f.hph)
    H = p.m * vpar**2 / 2.0 + p.mu * f.B + p.qe * f.Phie
    pth = p.m * f.hth * vpar + p.qe / p.c * f.Ath
    return torch.stack([H, pth, vpar])


def get_val(z, p: GCParams = GCParams()):
    """(H, pth, vpar) at z = (r, th, ph, pph): common.py:47-55."""
    v = _vals(_t(z), p)
    return v[0], v[1], v[2]


def get_der(z, p: GCParams = GCParams()):
    """Values + first derivatives: autodiff twin of common.py:57-87.

    Returns (H, pth, vpar, dHdx, dHdpph, dpthdx, dpthdpph, dvpardx,
    dvpardpph) with ``x = (r, th, ph)``, the reference's return layout.
    """
    z = _t(z)
    v = _vals(z, p)
    J = jacfwd(_vals)(z, p)  # (3 funcs, 4 coords)
    return (
        v[0], v[1], v[2],
        J[0, :3], J[0, 3],
        J[1, :3], J[1, 3],
        J[2, :3], J[2, 3],
    )


def _pack6(Hxx: Tensor) -> Tensor:
    """3x3 spatial Hessian -> reference 6-vector layout
    (d2dr2, d2dth2, d2dph2, d2drdth, d2drdph, d2dthdph): common.py:92-97."""
    return torch.stack(
        [Hxx[0, 0], Hxx[1, 1], Hxx[2, 2], Hxx[0, 1], Hxx[0, 2], Hxx[1, 2]]
    )


def get_der2(z, p: GCParams = GCParams()):
    """Values + first + second derivatives: autodiff twin of
    common.py:89-117.

    Returns the get_der() entries followed by (d2pthdx2, d2pthdpphdz,
    d2Hdx2, d2Hdpphdz, d2vpardx2, d2vpardpphdz), 6-vectors in (rr, thth,
    phph, rth, rph, thph) layout and 4-vectors in (pph·r, pph·th, pph·ph,
    pph·pph) layout.  Unlike the reference, ``d2Hdpphdz[3]`` carries the
    true d²H/dpph² = 1/(m hph²) instead of 0.
    """
    z = _t(z)
    first = get_der(z, p)
    Hess = hessian(_vals)(z, p)  # (3 funcs, 4, 4)

    def packs(k):
        return _pack6(Hess[k, :3, :3]), Hess[k, 3, :]

    d2Hdx2, d2Hdpphdz = packs(0)
    d2pthdx2, d2pthdpphdz = packs(1)
    d2vpardx2, d2vpardpphdz = packs(2)
    return (*first, d2pthdx2, d2pthdpphdz, d2Hdx2, d2Hdpphdz,
            d2vpardx2, d2vpardpphdz)


def get_val_batch(zs, p: GCParams = GCParams()):
    """``get_val`` over a (B, 4) stack of phase-space points."""
    return vmap(get_val, in_dims=(0, None))(_t(zs), p)


def get_der_batch(zs, p: GCParams = GCParams()):
    """``get_der`` over a (B, 4) stack of phase-space points."""
    return vmap(get_der, in_dims=(0, None))(_t(zs), p)


def get_der2_batch(zs, p: GCParams = GCParams()):
    """``get_der2`` over a (B, 4) stack of phase-space points."""
    return vmap(get_der2, in_dims=(0, None))(_t(zs), p)


def pph_from_ics(r0, th0, ph0, vpar0, p: GCParams = GCParams()):
    """Toroidal momentum from initial conditions (common.py:29-31):
    ``pph0 = m vpar0 hph + qe/c Aph``."""
    f = field_eval(r0, th0, ph0)
    return p.m * _t(vpar0) * f.hph + p.qe / p.c * f.Aph


def timesteps(steps_per_bounce: int, nbounce: int, taub: float = TAUB):
    """Step size and number of timesteps (common.py:14-16)."""
    return taub / steps_per_bounce, nbounce * steps_per_bounce


def newton_scalar(fdf, x0, rtol: float = 1e-12, atol: float = 1e-12,
                  maxiter: int = 50, args=()):
    """Batched lock-step Newton on a scalar residual.

    Twin of ``newton1`` / ``newton`` (common.py:129-153): ``fdf(x, *args)``
    returns ``(f(x), f'(x))`` elementwise over a batch; iteration continues
    while ANY lane fails both the reference's stopping rules (|f| > atol
    AND relative step > rtol), with converged lanes frozen by a mask, at
    most ``maxiter`` iterations.  The loop test is one host read a step
    (the JAX package runs it under ``lax.while_loop``).
    """
    x0 = _t(x0)

    def active_of(x, xold, fval):
        rel = torch.abs(x - xold) / (torch.abs(x) * (1.0 + 1e-30) + 1e-300)
        return (torch.abs(fval) > atol) & (rel > rtol)

    # seed the previous iterate *additively*: the multiplicative form
    # x0 * (1 + 1e30 rtol) equals x0 when x0 == 0, silently freezing that
    # lane (rel = 0 > rtol is False on every iteration) while other lanes
    # of the batched solve proceed.
    x = x0
    xold = x0 + (1.0 + torch.abs(x0)) * 1e30 * rtol
    fval = torch.full_like(x0, 1e30 * max(atol, 1e-300))
    for _ in range(maxiter):
        if not bool(active_of(x, xold, fval).any()):
            break
        f, df = fdf(x, *args)
        active = active_of(x, xold, f)
        x, xold, fval = torch.where(active, x - f / df, x), x, f
    return x
