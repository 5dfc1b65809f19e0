"""Hyperparameter inference (PyTorch port of ``sympgpr_tpu/gp/train.py``:
L-BFGS, CMA-ES, Adam, the batched Adam fits and the large-N on-device fit).

scipy L-BFGS-B runs on the host over a torch value-and-grad of the NLL;
CMA-ES runs its strategy on the host in numpy and evaluates each
generation's members one after another on the data's device.  The linear
algebra runs on the device the training data lives on.  The
hyperparameter transforms are the reference's two styles: ``log10``
(``hyp = 10**theta``) and ``linear`` (``hyp = |theta|``).
``minimize_adam``, ``fit_batch_adam`` (M datasets at once over
``likelihood.nll_batched``) and ``fit_sympgp_ondevice`` (an Adam loop over
the closed-form NLL gradient) share one update, ``adam_update``, and stay
on the device until their last step.
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
from sympgpr_tpu_torch.profiling import span

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


def minimize_cmaes(
    objective: Callable[[Tensor], Tensor],
    x0: Sequence[float],
    *,
    device: torch.device | str,
    dtype: torch.dtype = torch.float64,
    sigma0: float = 0.5,
    popsize: int | None = None,
    maxiter: int = 200,
    restarts: int = 0,
    seed: int = 0,
    tol_fun: float = 1e-11,
) -> FitResult:
    """CMA-ES (Hansen's standard (mu/mu_w, lambda) strategy), IPOP restarts
    doubling the population.

    The strategy's arithmetic and its ``np.random.default_rng(seed)``
    stream are the JAX package's line for line, so the two searches draw
    the same members and follow the same path wherever their objective
    values agree.  The JAX package evaluates a generation in one vmapped
    call; here each member is one objective call on ``device``.
    """
    x0 = np.asarray(x0, dtype=np.float64)
    n = x0.size

    def batch_obj(arx: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return np.array([float(objective(torch.tensor(
                x, dtype=dtype, device=device))) for x in arx])

    best_x, best_f, total_fev = x0.copy(), np.inf, 0
    lam0 = popsize or (4 + int(3 * np.log(n)))
    rng = np.random.default_rng(seed)

    for restart in range(restarts + 1):
        lam = lam0 * (2**restart)
        mu = lam // 2
        w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
        w /= w.sum()
        mueff = 1.0 / np.sum(w**2)
        cc = (4 + mueff / n) / (n + 4 + 2 * mueff / n)
        cs = (mueff + 2) / (n + mueff + 5)
        c1 = 2 / ((n + 1.3) ** 2 + mueff)
        cmu = min(1 - c1, 2 * (mueff - 2 + 1 / mueff) / ((n + 2) ** 2 + mueff))
        damps = 1 + 2 * max(0.0, np.sqrt((mueff - 1) / (n + 1)) - 1) + cs
        chiN = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n**2))

        xmean = x0.copy() if restart == 0 else best_x.copy()
        sigma = sigma0
        pc = np.zeros(n)
        ps = np.zeros(n)
        B = np.eye(n)
        D = np.ones(n)
        C = np.eye(n)
        eigeneval = 0
        counteval = 0

        prev_best = np.inf
        for it in range(maxiter):
            arz = rng.standard_normal((lam, n))
            ary = arz @ (B * D).T
            arx = xmean + sigma * ary
            f = batch_obj(arx)
            f = np.nan_to_num(f, nan=_BIG, posinf=_BIG)
            counteval += lam
            total_fev += lam
            idx = np.argsort(f)
            if f[idx[0]] < best_f:
                best_f = float(f[idx[0]])
                best_x = arx[idx[0]].copy()

            xold = xmean
            xmean = w @ arx[idx[:mu]]
            zmean = w @ arz[idx[:mu]]

            ps = (1 - cs) * ps + np.sqrt(cs * (2 - cs) * mueff) * (B @ zmean)
            hsig = (
                np.linalg.norm(ps)
                / np.sqrt(1 - (1 - cs) ** (2 * counteval / lam)) / chiN
                < 1.4 + 2 / (n + 1)
            )
            pc = (1 - cc) * pc + hsig * np.sqrt(cc * (2 - cc) * mueff) * (
                (xmean - xold) / sigma
            )
            artmp = (arx[idx[:mu]] - xold) / sigma
            C = (
                (1 - c1 - cmu) * C
                + c1 * (np.outer(pc, pc) + (1 - hsig) * cc * (2 - cc) * C)
                + cmu * (artmp.T * w) @ artmp
            )
            sigma *= np.exp((cs / damps) * (np.linalg.norm(ps) / chiN - 1))

            if counteval - eigeneval > lam / (c1 + cmu) / n / 10:
                eigeneval = counteval
                C = np.triu(C) + np.triu(C, 1).T
                Dsq, B = np.linalg.eigh(C)
                D = np.sqrt(np.maximum(Dsq, 1e-20))

            if abs(prev_best - f[idx[0]]) < tol_fun and it > 10:
                break
            prev_best = f[idx[0]]

    return FitResult(theta=best_x, fun=best_f, success=np.isfinite(best_f),
                     nfev=total_fev, message="cma-es")


B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def adam_update(theta: Tensor, g: Tensor, mu: Tensor, nu: Tensor, i: int,
                lr: float):
    """One Adam step at iteration i = 0, 1, ..., with optax's formula and a
    zero gradient where it is not finite; returns (theta, mu, nu).  Pure
    tensor arithmetic: no host read."""
    g = torch.where(torch.isfinite(g), g, 0.0)
    mu = (1 - B1) * g + B1 * mu
    nu = (1 - B2) * g**2 + B2 * nu
    mu_hat = mu / (1 - B1 ** (i + 1))
    nu_hat = nu / (1 - B2 ** (i + 1))
    return theta + -lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)), mu, nu


def minimize_adam(
    objective: Callable[[Tensor], Tensor],
    x0: Sequence[float],
    lr: float = 3e-2,
    steps: int = 300,
    *,
    device: torch.device | str,
    dtype: torch.dtype = torch.float64,
) -> FitResult:
    """``steps`` Adam iterations on ``device``; ``fun`` is the objective at
    the final theta, the one value read back."""
    theta = torch.as_tensor(np.asarray(x0, np.float64), dtype=dtype,
                            device=device)
    mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
    for i in range(steps):
        _, g = value_and_grad(objective, theta)
        theta, mu, nu = adam_update(theta, g, mu, nu, i, lr)
    with torch.no_grad():
        final = float(objective(theta))
    return FitResult(theta=theta.cpu().numpy(), fun=final,
                     success=bool(np.isfinite(final)), nfev=steps)


_MINIMIZERS = {
    "lbfgs": minimize_lbfgs,
    "cmaes": minimize_cmaes,
    "adam": minimize_adam,
}


def _hyp(res: FitResult, transform: str, fixed_sig, like: Tensor):
    theta = torch.as_tensor(res.theta, dtype=like.dtype, device=like.device)
    hyp = _apply_transform(theta, transform)
    if fixed_sig is None:
        return hyp[:-1], hyp[-1]
    return hyp, fixed_sig


def _minimize(optimizer: str, objective, x0, X: Tensor, bounds, tol,
              opt_kwargs: dict) -> FitResult:
    """Run the named optimizer on the training data's device and dtype."""
    if optimizer not in _MINIMIZERS:
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet; use one of "
            f"{sorted(_MINIMIZERS)}")
    if optimizer == "lbfgs":
        opt_kwargs = dict(opt_kwargs, bounds=bounds, tol=tol)
    return _MINIMIZERS[optimizer](objective, x0, device=X.device,
                                  dtype=X.dtype, **opt_kwargs)


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
    objective = make_objective(likelihood.nll, kernel, X, z, sig2n,
                               transform=transform, fixed_sig=fixed_sig)
    res = _minimize(optimizer, objective, x0, X, bounds, tol, opt_kwargs)
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
    objective = make_objective(
        likelihood.nll_reg, kernel, X, z,
        sig2n if nll_sig2n is None else nll_sig2n,
        transform=transform, fixed_sig=fixed_sig,
    )
    res = _minimize(optimizer, objective, x0, X, bounds, None, opt_kwargs)
    params, sig = _hyp(res, transform, fixed_sig, X)
    return AuxGP.create(kernel, params, sig, sig2n, X, z, delta=delta), res


def fit_sympgp_separable(
    kernel: Kernel,
    X: Tensor,
    z: Tensor,
    *,
    sig2n: float,
    nll_sig2n: float | None = None,
    x0_q: Sequence[float] = (1.0,),
    x0_p: Sequence[float] = (1.0,),
    fixed_sig: float,
    transform: str = "log10",
    bounds=None,
) -> tuple[SympGP, tuple[FitResult, FitResult]]:
    """Explicit-map training of a sum kernel: lq and lp fitted apart by
    L-BFGS on the two diagonal blocks (``likelihood.nll_separable``), at
    ``nll_sig2n`` when given; the final model solves at ``sig2n``."""
    n = X.shape[0]
    zp, zq = z[:n], z[n:]
    s2 = sig2n if nll_sig2n is None else nll_sig2n

    def make(block: int, zb: Tensor):
        def objective(theta: Tensor) -> Tensor:
            lq = _apply_transform(theta, transform)[0]
            # a diagonal block depends on its own lengthscale only; the
            # other is 1 (any finite value keeps its derivatives finite)
            one = torch.ones((), dtype=lq.dtype, device=lq.device)
            params = torch.stack([lq, one] if block == 0 else [one, lq])
            return likelihood.nll_separable(
                kernel, params,
                torch.tensor(fixed_sig, dtype=lq.dtype, device=lq.device),
                torch.tensor(s2, dtype=lq.dtype, device=lq.device), X, zb,
                block)
        return objective

    res_q = minimize_lbfgs(make(0, zp), x0_q, device=X.device,
                           dtype=X.dtype, bounds=bounds)
    res_p = minimize_lbfgs(make(1, zq), x0_p, device=X.device,
                           dtype=X.dtype, bounds=bounds)
    lq, lp = (float(torch.abs(_apply_transform(
        torch.as_tensor(r.theta, dtype=torch.float64), transform))
        .reshape(())) for r in (res_q, res_p))
    model = SympGP.create(kernel, [lq, lp], fixed_sig, sig2n, X, z)
    return model, (res_q, res_p)


def _adam(kernel: Kernel, X: Tensor, z: Tensor, theta: Tensor,
          sig2n: Tensor, steps: int, lr: float):
    """``steps`` Adam iterations (``adam_update``) over
    ``nll_value_and_grad_theta``.  Nothing leaves the device: returns
    (theta, NLL history) as tensors."""
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    hist = torch.empty(steps, dtype=theta.dtype, device=theta.device)
    for i in range(steps):
        with span("sympgpr::fit.step"):
            val, g = likelihood.nll_value_and_grad_theta(kernel, theta,
                                                         sig2n, X, z)
            with span("sympgpr::fit.update"):
                theta, mu, nu = adam_update(theta, g, mu, nu, i, lr)
                hist[i] = val
    return theta, hist


def _solve_at(kernel: Kernel, X: Tensor, z: Tensor, theta: Tensor,
              s2n: Tensor):
    """The model at the trained theta (alpha from a Cholesky solve at
    ``s2n``) and its training MSE."""
    hyp = 10.0 ** theta
    params, sig = hyp[:-1], hyp[-1]
    on_kernel = cuda_cov.want_cuda_build(kernel, X)
    if on_kernel:
        Ky = cuda_cov.build_Ky(kernel.name, X, params, sig, s2n)
    else:
        K = build_K_fast(kernel, X, X, params, sig)
        Ky = K + s2n * torch.eye(K.shape[0], dtype=X.dtype, device=X.device)
    L, info = torch.linalg.cholesky_ex(Ky)
    alpha = torch.where(info == 0, torch.cholesky_solve(z[:, None], L)[:, 0],
                        math.nan)
    model = SympGP.from_alpha(kernel, params, sig, s2n, X, z, alpha)
    # training MSE from the matrix just built (SympGP.training_error would
    # rebuild K through the autodiff build_K); K alpha = Ky alpha - s2n alpha
    Kalpha = Ky @ alpha - s2n * alpha if on_kernel else K @ alpha
    return model, float(torch.mean((Kalpha - z) ** 2))


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
    with span("sympgpr::fit"):
        while True:
            t0 = time.perf_counter()
            s2n = torch.tensor(sig2n, dtype=dtype, device=dev)
            theta, hist = _adam(kernel, X, z, theta0, s2n, steps, lr)
            with span("sympgpr::fit.finish"):
                hist = hist.cpu().numpy()  # the one fetch = sync
                if np.isfinite(hist[-1]) or escalations >= max_jitter_tries:
                    fit_s = time.perf_counter() - t_start
                    model, train_mse = _solve_at(kernel, X, z, theta, s2n)
                    break
            t_failed += time.perf_counter() - t0
            sig2n *= 10.0
            escalations += 1
    timings = {"fit_s": fit_s, "fit_escalation_s": t_failed,
               "sig2n_used": float(sig2n), "jitter_escalations": escalations}
    return model, hist, train_mse, timings


def fit_batch_adam(
    kernel: Kernel,
    Xs: Tensor,
    zs: Tensor,
    *,
    sig2n: float,
    x0: Sequence[float],
    transform: str = "log10",
    lr: float = 3e-2,
    steps: int = 300,
    reg: bool = False,
) -> tuple[Tensor, Tensor]:
    """Fit M GPs at once: Adam over ``likelihood.nll_batched`` of stacked
    datasets, the counterpart of the JAX package's vmapped fits.

    Xs: (M, N, 2) training sets; zs: (M, 2N) ((M, N) with ``reg``, the
    auxiliary GP's NLL).  Every set starts from x0 (the last component is
    the signal variance).  Returns (thetas (M, d), nlls (M,)) on the data's
    device; the loop reads nothing back but the NLL's failed rows.
    """
    theta = torch.as_tensor(np.asarray(x0, np.float64), dtype=Xs.dtype,
                            device=Xs.device).expand(Xs.shape[0], -1)

    def loss(theta: Tensor) -> Tensor:
        hyp = _apply_transform(theta, transform)
        return likelihood.nll_batched(kernel, hyp[:, :-1], hyp[:, -1], sig2n,
                                      Xs, zs, reg=reg)

    mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
    for i in range(steps):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss(th).sum(), th)
        theta, mu, nu = adam_update(theta, g, mu, nu, i, lr)
    with torch.no_grad():
        return theta, loss(theta)
