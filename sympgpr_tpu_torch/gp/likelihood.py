"""Negative log marginal likelihood for the symplectic and auxiliary GPs
(PyTorch port of ``sympgpr_tpu/gp/likelihood.py``).

Cholesky form (Rasmussen & Williams p.19) with the eigendecomposition
fallback at indefinite hyperparameters.  JAX signals a failed Cholesky with
a NaN factor; ``torch.linalg.cholesky_ex`` signals it through ``info``.  The
branch is taken in eager code on both signals (``info != 0`` or a
non-finite factor), and the fallback floors the spectrum so value and
gradient stay finite.  Gradients come from autograd, except in
``nll_value_and_grad``, the closed-form gradient of the large-N fit.

Above ``cuda_cov.nll_threshold()`` training points in float32 the
covariance comes from the hand-written build kernel
(``ops/cuda_cov.py``), with the contraction kernel as its backward; the
closed-form gradient takes the kernels' fused entries there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sympgpr_tpu_torch.gp.covariance import build_K_fast, build_Kreg
from sympgpr_tpu_torch.kernels.variants import Kernel
from sympgpr_tpu_torch.linalg.triangular import spd_inverse_from_chol
from sympgpr_tpu_torch.ops import cuda_cov

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
    if cuda_cov.want_cuda_build(kernel, X):
        K = cuda_cov.build_K_cuda(kernel, X, X, params, sig)
    else:
        K = build_K_fast(kernel, X, X, params, sig)
    Ky = K + torch.abs(sig2n) * _eye(K.shape[0], K)
    return _nll_from_Ky(Ky, z)


def nll_reg(kernel: Kernel, params: Tensor, sig: Tensor, sig2n: Tensor,
            X: Tensor, z: Tensor) -> Tensor:
    """NLL of the auxiliary ordinary GP. X: (N, 2) points (q, p); z: (N,)."""
    K = build_Kreg(kernel, X, X, params, sig)
    Ky = K + torch.abs(sig2n) * _eye(K.shape[0], K)
    return _nll_from_Ky(Ky, z)


def nll_value_and_grad(kernel: Kernel, params: Tensor, sig: Tensor,
                       sig2n: Tensor, X: Tensor, z: Tensor):
    """(nll, d nll/d params, d nll/d sig) without autograd through the
    Cholesky factorization: the closed form (Rasmussen & Williams 5.9)

        d nll / d theta = <0.5 (Ky^{-1} - alpha alpha^T), dK / d theta>

    with Ky^{-1} from the blocked triangular inverse and the syrk
    (``linalg/triangular.py``) on every device.  Where the build takes the
    kernel, its fused entries of ``ops/cuda_cov.py`` write Ky with |sig2n|
    on its diagonal, and form Kbar from S = Ky^{-1} and alpha on load in
    the contraction, so neither the identity, K apart from Ky, nor Kbar is
    stored; elsewhere autograd of ``build_K_fast`` contracts Kbar.
    ``sig2n`` is fixed.

    A failed factorization gives NaN in value and gradient, as in the JAX
    package: ``cholesky_ex`` reports it through ``info`` and leaves a
    finite partial factor, so a NaN scalar is added to the three results
    on the device, with no host sync.
    """
    fused = cuda_cov.want_cuda_build(kernel, X)
    if fused:
        Ky = cuda_cov.build_Ky(kernel.name, X, params, sig, torch.abs(sig2n))
    else:
        params = params.detach().requires_grad_(True)
        sig = sig.detach().requires_grad_(True)
        with torch.enable_grad():
            K_graph = build_K_fast(kernel, X, X, params, sig)
        K = K_graph.detach()
        Ky = K + torch.abs(sig2n) * _eye(K.shape[0], K)
    L, info = torch.linalg.cholesky_ex(Ky)
    poison = torch.where(info == 0, 0.0, math.nan).to(Ky.dtype)
    alpha = torch.cholesky_solve(z[:, None], L)[:, 0]
    val = 0.5 * z @ alpha + torch.sum(torch.log(torch.diagonal(L)))
    S = spd_inverse_from_chol(L)
    if fused:
        dparams, dsig = cuda_cov.cov_param_grads_sym(kernel.name, X, params,
                                                     sig, S, alpha)
    else:
        Kbar = 0.5 * S - 0.5 * torch.outer(alpha, alpha)
        dparams, dsig = torch.autograd.grad(K_graph, (params, sig), Kbar)
    return val + poison, dparams + poison, dsig + poison


def nll_value_and_grad_theta(kernel: Kernel, theta: Tensor, sig2n: Tensor,
                             X: Tensor, z: Tensor):
    """(value, grad) of theta -> nll(10**theta), closed-form gradient;
    theta = log10 (lengthscales..., sig)."""
    hyp = 10.0 ** theta
    params, sig = hyp[:-1], hyp[-1]
    val, dparams, dsig = nll_value_and_grad(kernel, params, sig, sig2n, X,
                                            z)
    dtheta = torch.cat([dparams * params,
                        torch.reshape(dsig * sig, (1,))]) * math.log(10.0)
    return val, dtheta


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
