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

alpha = Ky^{-1} z comes from two triangular solves with the Cholesky
factor (``torch.cholesky_solve``), except in ``nll_value_and_grad`` on a
CUDA device: that step forms S = Ky^{-1} for its gradient anyway, and
takes alpha = S z from it through the hand-written product kernel
(``ops/cuda_matvec.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sympgpr_tpu_torch.gp.covariance import build_K, build_K_fast, build_Kreg
from sympgpr_tpu_torch.kernels.variants import Kernel
from sympgpr_tpu_torch.linalg import potrf
from sympgpr_tpu_torch.linalg.triangular import spd_inverse_from_chol
from sympgpr_tpu_torch.ops import cuda_cov, cuda_matvec
from sympgpr_tpu_torch.profiling import span

Tensor = torch.Tensor


def _eig_nll(Ky: Tensor, z: Tensor) -> Tensor:
    """The NLL through eigh with the spectrum floored, so value and
    gradient stay finite; over any leading batch."""
    w, Q = torch.linalg.eigh(Ky)
    floor = torch.clamp(torch.amax(torch.abs(w), -1, keepdim=True) * 1e-14,
                        min=1e-300)
    w = torch.maximum(w, floor)
    Qz = (Q.mT @ z[..., None])[..., 0]
    alpha = (Q @ (Qz / w)[..., None])[..., 0]
    return 0.5 * (z * alpha).sum(-1) + 0.5 * torch.log(w).sum(-1)


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
    return _eig_nll(Ky, z)


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


class _Poison(torch.autograd.Function):
    """Per row of a (B, n, n) stack: NaN where ``nan_value`` and 0
    elsewhere, with a NaN gradient on the rows where ``nan_grad`` and 0
    elsewhere.  Added to a batch of NLLs, it gives a failed row JAX's NaN
    pattern (a failed Cholesky's VJP is NaN under ``vmap``) with no host
    read and no NaN leaking into the other rows."""

    @staticmethod
    def forward(ctx, A, nan_value, nan_grad):
        ctx.save_for_backward(nan_grad)
        ctx.shape = A.shape
        return torch.where(nan_value, math.nan, 0.0).to(A.dtype)

    @staticmethod
    def backward(ctx, g):
        (nan_grad,) = ctx.saved_tensors
        row = torch.where(nan_grad, math.nan, 0.0).to(g.dtype)
        return row[:, None, None].expand(ctx.shape), None, None


def nll_batched(kernel: Kernel, params: Tensor, sig: Tensor, sig2n,
                X: Tensor, z: Tensor, reg: bool = False) -> Tensor:
    """NLL over a leading batch of B hyperparameter rows: the counterpart
    of ``jax.vmap(nll)`` (``reg=True``: of ``jax.vmap(nll_reg)``).

    params: (B, d); sig: (B,); X: (N, 2) shared or (B, N, 2) one set a
    row; z: (2N,) or (B, 2N) ((N,) or (B, N) with ``reg``).  Returns (B,).

    The product kernels' covariances are built by broadcasting
    ``build_K_fast`` over the batch, the others under ``torch.func.vmap``;
    they are factored by one batched ``cholesky_ex``; alpha comes from two batched triangular
    solves.  A row whose Ky is not finite is NaN in value and gradient; a
    row whose factorization fails takes the floored-eigh value of
    ``_nll_from_Ky`` and a NaN gradient, the pattern of JAX's
    ``jax.vmap(jax.value_and_grad(nll))``.  The failed rows are read to
    the host once per call (the only host read on the path); eigh runs on
    them alone (and reads its own status back, on that rare path only).
    """
    if not reg and kernel.product:
        K = build_K_fast(kernel, X, X, params.T[..., None, None],
                         sig[:, None, None])
    else:
        build = build_Kreg if reg else build_K_fast
        K = torch.func.vmap(
            lambda p, s, x: build(kernel, x, x, p, s),
            in_dims=(0, 0, 0 if X.dim() == 3 else None))(params, sig, X)
    n = K.shape[-1]
    # a Python float stays a kernel argument: no copy to the card
    s2n = torch.abs(sig2n) if isinstance(sig2n, Tensor) else abs(sig2n)
    Ky = K + s2n * _eye(n, K)
    z = z.expand(K.shape[0], n)
    finite = torch.isfinite(Ky).flatten(1).all(-1)
    L, info = torch.linalg.cholesky_ex(Ky)
    failed = (info != 0) | ~torch.isfinite(L).flatten(1).all(-1)
    y = torch.linalg.solve_triangular(L, z[..., None], upper=False)
    alpha = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    val = (0.5 * (z * alpha).sum(-1)
           + torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1))
    flags = torch.stack([failed, finite]).cpu()  # the one host read
    if not bool(flags[0].any()):
        return val
    rows = flags[0] & flags[1]
    if bool(rows.any()):
        idx = rows.nonzero()[:, 0]
        if Ky.is_cuda:
            idx = idx.pin_memory().to(Ky.device, non_blocking=True)
        val = val.index_put((idx,), _eig_nll(Ky.index_select(0, idx),
                                             z.index_select(0, idx)))
    return val + _Poison.apply(Ky, ~finite, failed)


def nll_separable(kernel: Kernel, params: Tensor, sig: Tensor,
                  sig2n: Tensor, X: Tensor, z_block: Tensor,
                  block: int) -> Tensor:
    """Per-block NLL of the separable (sum) kernel, for explicit training:
    block 0 is the (dq dq') block against z_p, block 1 the (dP dP') block
    against z_q."""
    K = build_K(kernel, X, X, params, sig)
    n = X.shape[0]
    sl = slice(0, n) if block == 0 else slice(n, 2 * n)
    Ky = K[sl, sl] + torch.abs(sig2n) * _eye(n, K)
    return _nll_from_Ky(Ky, z_block)


def nll_value_and_grad(kernel: Kernel, params: Tensor, sig: Tensor,
                       sig2n: Tensor, X: Tensor, z: Tensor):
    """(nll, d nll/d params, d nll/d sig) without autograd through the
    Cholesky factorization: the closed form (Rasmussen & Williams 5.9)

        d nll / d theta = <0.5 (Ky^{-1} - alpha alpha^T), dK / d theta>

    with Ky^{-1} from the blocked triangular inverse and the syrk
    (``linalg/triangular.py``) on every device.  alpha = Ky^{-1} z comes
    from that S on a CUDA device, S z through ``ops/cuda_matvec.py``'s
    kernel (one read of S, where the two triangular solves run a chain
    down the factor), and from ``torch.cholesky_solve`` with the factor on
    the CPU.  Where the build takes the
    kernel, its fused entries of ``ops/cuda_cov.py`` write Ky with |sig2n|
    on its diagonal, and form Kbar from S = Ky^{-1} and alpha on load in
    the contraction, so neither the identity, K apart from Ky, nor Kbar is
    stored; elsewhere autograd of ``build_K_fast`` contracts Kbar.
    ``sig2n`` is fixed.

    Ky is a buffer of this step's own, read by nothing after its factor,
    so on a CUDA device the factor is written over it, row-major
    (``linalg/potrf.py::cholesky_in_place``: the hand-written blocked
    Cholesky, with no copy in, no mask and no copy back).  The strict upper
    triangle of that L still holds Ky's entries; the step reads L's lower
    triangle only (the inverse's base solves and products, the diagonal
    for the log-determinant).

    A failed factorization gives NaN in value and gradient, as in the JAX
    package: the factor reports it through ``info`` on the device and may
    leave NaN below the failing column, so a NaN scalar is added to the
    three results on the device, with no host sync.
    """
    fused = cuda_cov.want_cuda_build(kernel, X)
    with span("sympgpr::nll.build"):
        if fused:
            Ky = cuda_cov.build_Ky(kernel.name, X, params, sig,
                                   torch.abs(sig2n))
        else:
            params = params.detach().requires_grad_(True)
            sig = sig.detach().requires_grad_(True)
            with torch.enable_grad():
                K_graph = build_K_fast(kernel, X, X, params, sig)
            K = K_graph.detach()
            Ky = K + torch.abs(sig2n) * _eye(K.shape[0], K)
    with span("sympgpr::nll.factor"):
        L, info = potrf.cholesky_in_place(Ky)
        poison = torch.where(info == 0, 0.0, math.nan).to(Ky.dtype)
    S = spd_inverse_from_chol(L)
    with span("sympgpr::nll.alpha"):
        if S.is_cuda:
            alpha = cuda_matvec.matvec(S, z)
        else:
            alpha = torch.cholesky_solve(z[:, None], L)[:, 0]
        val = 0.5 * z @ alpha + torch.sum(torch.log(torch.diagonal(L)))
    with span("sympgpr::nll.contraction"):
        if fused:
            dparams, dsig = cuda_cov.cov_param_grads_sym(kernel.name, X,
                                                         params, sig, S,
                                                         alpha)
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
