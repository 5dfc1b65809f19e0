"""The periodic x squared-exponential kernel (SympGPR ``kernels.f90``),
plain PyTorch in the dtype of its inputs:

  k(u, v) = exp(-sin^2((u_q - v_q)/2) / (2 lx^2) - (u_P - v_P)^2 / (2 ly^2))

at points u = (q, P).  The symplectic GP's derivative-observation
covariance pairs sig d^2 k / du_r dv_c with the targets z = (p - P | Q - q);
the aux GP regresses on sig k itself.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _factors(dq: Tensor, dP: Tensor, lx, ly):
    """k, s', s'' of the q side and 1/ly^2 for differences dq, dP."""
    k = torch.exp(-torch.sin(0.5 * dq) ** 2 / (2.0 * lx**2)
                  - dP**2 / (2.0 * ly**2))
    sp = torch.sin(dq) / (4.0 * lx**2)
    spp = torch.cos(dq) / (4.0 * lx**2)
    return k, sp, spp, 1.0 / ly**2


def cov_blocks(X: Tensor, X0: Tensor, lx, ly, sig):
    """The four (N, N0) blocks (qq, qP, Pq, PP) of sig d^2k/du dv."""
    dq = X[:, None, 0] - X0[None, :, 0]
    dP = X[:, None, 1] - X0[None, :, 1]
    k, sp, spp, il2 = _factors(dq, dP, lx, ly)
    qq = (spp - sp**2) * k
    qP = -sp * dP * il2 * k
    PP = (il2 - dP**2 * il2**2) * k
    return sig * qq, sig * qP, sig * qP, sig * PP


def cov_reg(X: Tensor, X0: Tensor, lx, ly, sig) -> Tensor:
    """(N, N0) plain kernel matrix of the aux GP."""
    dq = X[:, None, 0] - X0[None, :, 0]
    dP = X[:, None, 1] - X0[None, :, 1]
    return sig * _factors(dq, dP, lx, ly)[0]


def aux_mean(Xa: Tensor, alpha_a: Tensor, lx, ly, sig, q: Tensor,
             p: Tensor) -> Tensor:
    """Aux GP mean of P - p at (q, p), a (B,) batch."""
    dq = Xa[None, :, 0] - q[:, None]
    dp = Xa[None, :, 1] - p[:, None]
    k = torch.exp(-torch.sin(0.5 * dq) ** 2 / (2.0 * lx**2)
                  - dp**2 / (2.0 * ly**2))
    return sig * (k @ alpha_a)


def gen_derivs(X: Tensor, alpha: Tensor, lx, ly, sig, q: Tensor,
               P: Tensor):
    """(dg/dq, d^2g/dq dP, dg/dP) at (q, P) for a (B,) batch, g the mean
    of the generating function: g(v) = sig sum_i a0_i dk/du_q(u_i, v) +
    a1_i dk/du_P(u_i, v)."""
    n = X.shape[0]
    a0, a1 = alpha[:n], alpha[n:]
    d = X[None, :, 0] - q[:, None]
    e = X[None, :, 1] - P[:, None]
    il2 = 1.0 / ly**2
    k = torch.exp(-torch.sin(0.5 * d) ** 2 / (2.0 * lx**2) - e**2 * il2 / 2)
    sp = torch.sin(d) / (4.0 * lx**2)
    spp = torch.cos(d) / (4.0 * lx**2)
    # dk/du_q = -s' k, dk/du_P = -e il2 k; derivatives in v = (q, P)
    # follow from d/dv = -d/du on the differences
    pgp = sig * (((spp - sp**2) * k) @ a0 + (-sp * e * il2 * k) @ a1)
    slope = sig * (((spp - sp**2) * e * il2 * k) @ a0
                   + (-sp * il2 * (e**2 * il2 - 1.0) * k) @ a1)
    dq = sig * ((-sp * e * il2 * k) @ a0
                + ((il2 - e**2 * il2**2) * k) @ a1)
    return pgp, slope, dq
