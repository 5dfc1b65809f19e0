"""Negative log marginal likelihood for the symplectic and auxiliary GPs
(PyTorch port of ``sympgpr_tpu/gp/likelihood.py``).

Cholesky form (Rasmussen & Williams p.19) with the eigendecomposition
fallback at indefinite hyperparameters.  JAX signals a failed Cholesky with
a NaN factor; ``torch.linalg.cholesky_ex`` signals it through ``info``.  The
branch is taken in eager code on both signals (``info != 0`` or a
non-finite factor), and the fallback floors the spectrum so value and
gradient stay finite.  Gradients come from autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from sympgpr_tpu_torch.gp.covariance import build_K_fast, build_Kreg
from sympgpr_tpu_torch.kernels.variants import Kernel

Tensor = torch.Tensor


def _nll_from_Ky(Ky: Tensor, z: Tensor) -> Tensor:
    """0.5 z^T Ky^{-1} z + 0.5 log det Ky (up to a constant), robustly."""
    if not bool(torch.isfinite(Ky).all()):
        # JAX yields NaN here (NaN factor, then NaN eigh); keep the NaN
        # differentiable so the optimizer guard sees it in value and grad
        return Ky.sum() * float("nan")
    L, info = torch.linalg.cholesky_ex(Ky)
    if int(info) == 0 and bool(torch.isfinite(L).all()):
        alpha = torch.cholesky_solve(z[:, None], L)[:, 0]
        return 0.5 * z @ alpha + torch.sum(torch.log(torch.diagonal(L)))
    w, Q = torch.linalg.eigh(Ky)
    floor = torch.clamp(torch.max(torch.abs(w)) * 1e-14, min=1e-300)
    w = torch.maximum(w, floor)
    alpha = Q @ ((Q.T @ z) / w)
    return 0.5 * z @ alpha + 0.5 * torch.sum(torch.log(w))


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def nll(kernel: Kernel, params: Tensor, sig: Tensor, sig2n: Tensor,
        X: Tensor, z: Tensor) -> Tensor:
    """NLL of the symplectic GP. X: (N, 2) points (q, P); z: (2N,)."""
    K = build_K_fast(kernel, X, X, params, sig)
    Ky = K + torch.abs(sig2n) * _eye(K.shape[0], K)
    return _nll_from_Ky(Ky, z)


def nll_reg(kernel: Kernel, params: Tensor, sig: Tensor, sig2n: Tensor,
            X: Tensor, z: Tensor) -> Tensor:
    """NLL of the auxiliary ordinary GP. X: (N, 2) points (q, p); z: (N,)."""
    K = build_Kreg(kernel, X, X, params, sig)
    Ky = K + torch.abs(sig2n) * _eye(K.shape[0], K)
    return _nll_from_Ky(Ky, z)


def chol_and_alpha(Ky: Tensor, z: Tensor,
                   max_jitter_tries: int = 6) -> tuple[Tensor, Tensor]:
    """Cholesky factor and alpha = Ky^{-1} z.

    On failure the jitter is escalated geometrically from
    ``1e-12 * max(diag)`` until the factorization succeeds.
    """
    L, info = torch.linalg.cholesky_ex(Ky)
    if int(info) == 0 and bool(torch.isfinite(L).all()):
        return L, torch.cholesky_solve(z[:, None], L)[:, 0]
    eye = _eye(Ky.shape[0], Ky)
    jitter = 1e-12 * float(torch.max(torch.diagonal(Ky)))
    for _ in range(max_jitter_tries):
        L, info = torch.linalg.cholesky_ex(Ky + jitter * eye)
        if int(info) == 0 and bool(torch.isfinite(L).all()):
            return L, torch.cholesky_solve(z[:, None], L)[:, 0]
        jitter *= 100.0
    raise np.linalg.LinAlgError(
        "covariance not positive definite even after jitter escalation"
    )
