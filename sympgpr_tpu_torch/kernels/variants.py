"""Kernel definitions for symplectic GP regression (PyTorch port).

Counterpart of ``sympgpr_tpu/kernels/variants.py``: each kernel is one
closed-form scalar function of two phase-space points, and its derivative
set comes from ``torch.func`` (``grad`` for the first-point gradient,
``jacfwd`` of ``grad`` for the mixed Hessian block of the
derivative-observation covariance).

Conventions are those of the JAX package: a point is ``u = (q, P)``;
``fn(u, v, params) -> scalar`` with ``params`` the kernel shape parameters
(lengthscales first); the signal variance ``sig`` scales the assembled
covariance and is not part of ``params``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import grad, jacfwd

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A stationary scalar kernel over 2-D phase-space points.

    Attributes:
      name: registry key (shared with the JAX package and the ``.npz``
        model artifacts).
      n_params: number of shape parameters.
      fn: ``fn(u, v, params) -> scalar`` with ``u, v`` of shape ``(2,)``.
      separable: True for a sum k_q + k_P (the mixed block vanishes and the
        map is explicit, Algorithm 2).
      code: its kind in the CUDA sources; None where they hold none.
      q_factors: ``(dq, params) -> (A, s', s'')`` of the q-side factor
        A = exp(-s(dq)) (a sum's q addend's); None: autodiff paths only.
      learns_freq: ``params[2]`` is the q-side frequency (else it is 1/2).
    """

    name: str
    n_params: int
    fn: Callable[[Tensor, Tensor, Tensor], Tensor] = dataclasses.field(
        compare=False)
    separable: bool = False
    code: int | None = None
    q_factors: Callable[[Tensor, Tensor], tuple[Tensor, Tensor, Tensor]] \
        | None = dataclasses.field(default=None, compare=False)
    learns_freq: bool = False

    @property
    def fast_map(self) -> bool:
        """The factorized map path (``maps/fast_apply.py``) applies."""
        return self.q_factors is not None

    @property
    def product(self) -> bool:
        """A(dq) * B(dP), B = exp(-dP^2 / (2 ly^2)): closed-form blocks."""
        return self.fast_map and not self.separable

    def grad_u(self, u: Tensor, v: Tensor, params: Tensor) -> Tensor:
        """(2,) gradient with respect to the first point."""
        return grad(self.fn, argnums=0)(u, v, params)

    def hess_uv(self, u: Tensor, v: Tensor, params: Tensor) -> Tensor:
        """(2, 2) matrix H[r, c] = d^2 k / du_r dv_c."""
        return jacfwd(grad(self.fn, argnums=0), argnums=1)(u, v, params)


def _per_se(u: Tensor, v: Tensor, p: Tensor) -> Tensor:
    lx, ly = p[0], p[1]
    dq = u[0] - v[0]
    dP = u[1] - v[1]
    return torch.exp(
        -torch.sin(0.5 * dq) ** 2 / (2.0 * lx**2) - dP**2 / (2.0 * ly**2)
    )


def _se_se(u: Tensor, v: Tensor, p: Tensor) -> Tensor:
    lx, ly = p[0], p[1]
    dq = u[0] - v[0]
    dP = u[1] - v[1]
    return torch.exp(-dq**2 / (2.0 * lx**2) - dP**2 / (2.0 * ly**2))


def _sum_per_se(u: Tensor, v: Tensor, p: Tensor) -> Tensor:
    lx, ly = p[0], p[1]
    dq = u[0] - v[0]
    dP = u[1] - v[1]
    return torch.exp(-torch.sin(0.5 * dq) ** 2 / (2.0 * lx**2)) + torch.exp(
        -dP**2 / (2.0 * ly**2)
    )


def _per_se_freq(u: Tensor, v: Tensor, p: Tensor) -> Tensor:
    lx, ly, freq = p[0], p[1], p[2]
    dq = u[0] - v[0]
    dP = u[1] - v[1]
    return torch.exp(
        -torch.sin(freq * dq) ** 2 / (2.0 * lx**2) - dP**2 / (2.0 * ly**2)
    )


def _per_se_q(d: Tensor, p: Tensor):
    lx = p[0]
    s = torch.sin(0.5 * d) ** 2 / (2.0 * lx**2)
    sp = torch.sin(d) / (4.0 * lx**2)
    spp = torch.cos(d) / (4.0 * lx**2)
    return torch.exp(-s), sp, spp


def _se_se_q(d: Tensor, p: Tensor):
    lx = p[0]
    s = d**2 / (2.0 * lx**2)
    sp = d / lx**2
    spp = torch.ones_like(d) / lx**2
    return torch.exp(-s), sp, spp


def _per_se_freq_q(d: Tensor, p: Tensor):
    lx, f = p[0], p[2]
    s = torch.sin(f * d) ** 2 / (2.0 * lx**2)
    sp = f * torch.sin(2.0 * f * d) / (2.0 * lx**2)
    spp = f**2 * torch.cos(2.0 * f * d) / lx**2
    return torch.exp(-s), sp, spp


PER_SE = Kernel("per_se", 2, _per_se, code=0, q_factors=_per_se_q)
SE_SE = Kernel("se_se", 2, _se_se, code=1, q_factors=_se_se_q)
PER_SE_FREQ = Kernel("per_se_freq", 3, _per_se_freq, code=2,
                     q_factors=_per_se_freq_q, learns_freq=True)
SUM_PER_SE = Kernel("sum_per_se", 2, _sum_per_se, separable=True, code=3,
                    q_factors=_per_se_q)

KERNELS: dict[str, Kernel] = {
    k.name: k for k in (PER_SE, SE_SE, SUM_PER_SE, PER_SE_FREQ)
}
BY_CODE: dict[int, Kernel] = {k.code: k for k in KERNELS.values()}


def get_kernel(name: str) -> Kernel:
    try:
        return KERNELS[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name!r}; available: {sorted(KERNELS)}"
        ) from None
