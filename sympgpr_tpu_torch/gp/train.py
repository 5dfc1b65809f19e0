"""Hyperparameter inference (PyTorch port of the L-BFGS part and the
large-N on-device fit of ``sympgpr_tpu/gp/train.py``).

scipy L-BFGS-B runs on the host over a torch value-and-grad of the NLL;
the linear algebra runs on the device the training data lives on.  The
hyperparameter transforms are the reference's two styles: ``log10``
(``hyp = 10**theta``) and ``linear`` (``hyp = |theta|``).
``fit_sympgp_ondevice`` is an Adam loop over the closed-form NLL gradient
that stays on the device until its last step.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Sequence

import numpy as np
import scipy.optimize
import torch

from sympgpr_tpu_torch.gp import likelihood
from sympgpr_tpu_torch.gp.covariance import build_K_fast
from sympgpr_tpu_torch.gp.model import AuxGP, SympGP
from sympgpr_tpu_torch.kernels.variants import Kernel
from sympgpr_tpu_torch.ops import cuda_cov

Tensor = torch.Tensor

_BIG = 1e30


@dataclasses.dataclass
class FitResult:
    theta: np.ndarray
    fun: float
    success: bool
    nfev: int
    message: str = ""


def _apply_transform(theta: Tensor, transform: str) -> Tensor:
    if transform == "log10":
        return 10.0 ** theta
    if transform == "linear":
        return torch.abs(theta)
    raise ValueError(f"unknown transform {transform!r}")


def make_objective(
    nll_fn: Callable[..., Tensor],
    kernel: Kernel,
    X: Tensor,
    z: Tensor,
    sig2n: float,
    *,
    transform: str = "log10",
    fixed_sig: float | None = None,
) -> Callable[[Tensor], Tensor]:
    """Objective theta -> NLL.  With ``fixed_sig=None`` the last component
    of theta is the signal variance."""

    def objective(theta: Tensor) -> Tensor:
        hyp = _apply_transform(theta, transform)
        if fixed_sig is None:
            params, sig = hyp[:-1], hyp[-1]
        else:
            params = hyp
            sig = torch.tensor(fixed_sig, dtype=theta.dtype,
                               device=theta.device)
        s2n = torch.tensor(sig2n, dtype=theta.dtype, device=theta.device)
        return nll_fn(kernel, params, sig, s2n, X, z)

    return objective


def value_and_grad(objective: Callable[[Tensor], Tensor], theta: Tensor):
    """(value, gradient) of a scalar objective at ``theta``."""
    theta = theta.detach().requires_grad_(True)
    v = objective(theta)
    (g,) = torch.autograd.grad(v, theta)
    return v.detach(), g


def minimize_lbfgs(
    objective: Callable[[Tensor], Tensor],
    x0: Sequence[float],
    *,
    device: torch.device | str,
    dtype: torch.dtype = torch.float64,
    bounds=None,
    tol: float | None = None,
    maxiter: int = 200,
) -> FitResult:
    """scipy L-BFGS-B over a torch value-and-grad of the objective.

    Non-finite values and gradients are mapped to 1e30 and finite numbers
    exactly as in the JAX package, so the line search backs off.
    """
    x0 = np.asarray(x0, dtype=np.float64)

    def fun(x):
        v, g = value_and_grad(
            objective, torch.tensor(x, dtype=dtype, device=device))
        v = float(np.nan_to_num(v.cpu().numpy(), nan=_BIG, posinf=_BIG))
        g = np.nan_to_num(g.cpu().numpy().astype(np.float64))
        return v, g

    res = scipy.optimize.minimize(
        fun, x0, jac=True, method="L-BFGS-B", bounds=bounds, tol=tol,
        options={"maxiter": maxiter},
    )
    return FitResult(theta=np.asarray(res.x), fun=float(res.fun),
                     success=bool(res.success), nfev=int(res.nfev),
                     message=str(res.message))


def _hyp(res: FitResult, transform: str, fixed_sig, like: Tensor):
    theta = torch.as_tensor(res.theta, dtype=like.dtype, device=like.device)
    hyp = _apply_transform(theta, transform)
    if fixed_sig is None:
        return hyp[:-1], hyp[-1]
    return hyp, fixed_sig


def _check_optimizer(optimizer: str) -> None:
    if optimizer != "lbfgs":
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet; use 'lbfgs'")


def fit_sympgp(
    kernel: Kernel,
    X: Tensor,
    z: Tensor,
    *,
    sig2n: float,
    x0: Sequence[float],
    fixed_sig: float | None = None,
    transform: str = "log10",
    optimizer: str = "lbfgs",
    bounds=None,
    tol: float | None = None,
    **opt_kwargs,
) -> tuple[SympGP, FitResult]:
    """Fit the symplectic GP: optimize hyp, then build alpha/L."""
    _check_optimizer(optimizer)
    objective = make_objective(likelihood.nll, kernel, X, z, sig2n,
                               transform=transform, fixed_sig=fixed_sig)
    res = minimize_lbfgs(objective, x0, device=X.device, dtype=X.dtype,
                         bounds=bounds, tol=tol, **opt_kwargs)
    params, sig = _hyp(res, transform, fixed_sig, X)
    return SympGP.create(kernel, params, sig, sig2n, X, z), res


def fit_auxgp(
    kernel: Kernel,
    X: Tensor,
    z: Tensor,
    *,
    sig2n: float,
    x0: Sequence[float],
    fixed_sig: float | None = None,
    transform: str = "log10",
    optimizer: str = "lbfgs",
    bounds=None,
    delta: bool = True,
    nll_sig2n: float | None = None,
    **opt_kwargs,
) -> tuple[AuxGP, FitResult]:
    """Fit the auxiliary ordinary GP (Newton initial-guess regression).

    ``nll_sig2n`` lets the optimization use another noise level than the
    final solve (the tokamak workload optimizes at 1e-8, solves at 1e-14).
    """
    _check_optimizer(optimizer)
    objective = make_objective(
        likelihood.nll_reg, kernel, X, z,
        sig2n if nll_sig2n is None else nll_sig2n,
        transform=transform, fixed_sig=fixed_sig,
    )
    res = minimize_lbfgs(objective, x0, device=X.device, dtype=X.dtype,
                         bounds=bounds, **opt_kwargs)
    params, sig = _hyp(res, transform, fixed_sig, X)
    return AuxGP.create(kernel, params, sig, sig2n, X, z, delta=delta), res


def _adam(kernel: Kernel, X: Tensor, z: Tensor, theta: Tensor,
          sig2n: Tensor, steps: int, lr: float):
    """``steps`` Adam iterations over ``nll_value_and_grad_theta``, with
    optax's formula (b1 0.9, b2 0.999, eps 1e-8) and a zero gradient where
    it is not finite.  Nothing leaves the device: returns (theta, NLL
    history) as tensors."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    hist = torch.empty(steps, dtype=theta.dtype, device=theta.device)
    for i in range(steps):
        val, g = likelihood.nll_value_and_grad_theta(kernel, theta, sig2n, X,
                                                     z)
        g = torch.where(torch.isfinite(g), g, 0.0)
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g**2 + b2 * nu
        mu_hat = mu / (1 - b1 ** (i + 1))
        nu_hat = nu / (1 - b2 ** (i + 1))
        theta = theta + -lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
        hist[i] = val
    return theta, hist


def fit_sympgp_ondevice(
    kernel: Kernel,
    X: Tensor,
    z: Tensor,
    *,
    sig2n: float,
    theta0: Sequence[float] = (0.5, 2.5, 2.0),
    steps: int = 60,
    lr: float = 5e-2,
    max_jitter_tries: int = 7,
):
    """Large-N fit on the device: Adam over the closed-form value and
    gradient (hand-written covariance, syrk and triangular-matmul kernels
    on CUDA), then the alpha solve at the trained hyperparameters.

    The NLL history stays on the device and is fetched once per attempt.
    Jitter escalation: a non-finite final NLL (the float32 Cholesky goes
    indefinite when ``sig2n`` is too small for the conditioning) refits at
    ten times the jitter, at most ``max_jitter_tries`` times.

    Returns ``(model, nll_history, train_mse, timings)``; timings holds
    ``fit_s`` (all attempts), ``fit_escalation_s`` (the failed ones),
    ``sig2n_used`` and ``jitter_escalations``.
    """
    dtype, dev = X.dtype, X.device
    theta0 = torch.as_tensor(np.log10(np.asarray(theta0, np.float64)),
                             dtype=dtype, device=dev)
    escalations = 0
    t_failed = 0.0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        s2n = torch.tensor(sig2n, dtype=dtype, device=dev)
        theta, hist = _adam(kernel, X, z, theta0, s2n, steps, lr)
        hist = hist.cpu().numpy()  # the one fetch = sync
        if np.isfinite(hist[-1]) or escalations >= max_jitter_tries:
            break
        t_failed += time.perf_counter() - t0
        sig2n *= 10.0
        escalations += 1
    fit_s = time.perf_counter() - t_start

    hyp = 10.0 ** theta
    params, sig = hyp[:-1], hyp[-1]
    on_kernel = cuda_cov.want_cuda_build(kernel, X)
    if on_kernel:
        Ky = cuda_cov.build_Ky(kernel.name, X, params, sig, s2n)
    else:
        K = build_K_fast(kernel, X, X, params, sig)
        Ky = K + s2n * torch.eye(K.shape[0], dtype=dtype, device=dev)
    L, info = torch.linalg.cholesky_ex(Ky)
    alpha = torch.where(info == 0, torch.cholesky_solve(z[:, None], L)[:, 0],
                        math.nan)
    model = SympGP.from_alpha(kernel, params, sig, s2n, X, z, alpha)
    # training MSE from the matrix just built (SympGP.training_error would
    # rebuild K through the autodiff build_K); K alpha = Ky alpha - s2n alpha
    Kalpha = Ky @ alpha - s2n * alpha if on_kernel else K @ alpha
    train_mse = float(torch.mean((Kalpha - z) ** 2))
    timings = {"fit_s": fit_s, "fit_escalation_s": t_failed,
               "sig2n_used": float(sig2n), "jitter_escalations": escalations}
    return model, hist, train_mse, timings
