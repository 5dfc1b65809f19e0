"""The symplectic GP, plain PyTorch, over a kernel found by name
(``gpbench/reference/kernels/<name>.py``): the derivative-observation
covariance, the negative log marginal likelihood and its closed-form
gradient, the Adam fit, and one step of the learned implicit map.
Every function computes in the dtype of its inputs; the checks call it in
float64, the controls in a lower precision.

The covariance K[r N + i, c N0 + j] = sig d^2 k / du_r dv_c (u_i, v_j) at
points u = (q, P) pairs with the targets z = (p - P | Q - q).  The map
from (q, p): solve p = P + dg/dq(q, P) for P, then Q = q + dg/dP(q, P),
with g the posterior mean of the generating function.
"""

from __future__ import annotations

import importlib
import math
from types import ModuleType

import numpy as np
import torch

Tensor = torch.Tensor
ROWS = 512  # points a block of the covariance's rows


def kernel(name: str) -> ModuleType:
    """The reference kernel ``gpbench/reference/kernels/<name>.py``, by the
    name the configuration and the program give it: ``cov_blocks``,
    ``cov_reg``, ``aux_mean`` and ``gen_derivs``."""
    return importlib.import_module(f"gpbench.reference.kernels.{name}")


def cov(kern, X: Tensor, X0: Tensor, lx, ly, sig) -> Tensor:
    """(2N, 2N0) derivative-observation covariance."""
    qq, qP, Pq, PP = kern.cov_blocks(X, X0, lx, ly, sig)
    return torch.cat([torch.cat([qq, qP], 1), torch.cat([Pq, PP], 1)], 0)


def solve(K: Tensor, s2n, z: Tensor) -> Tensor:
    """alpha = (K + s2n I)^{-1} z by Cholesky; NaN where it fails."""
    Ky = K + s2n * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    L, info = torch.linalg.cholesky_ex(Ky)
    alpha = torch.cholesky_solve(z[:, None], L)[:, 0]
    return torch.where(info == 0, alpha, math.nan)


def deploy_jitter(K: Tensor, rel: float):
    """The deployment noise: ``rel`` times the largest diagonal entry."""
    return rel * torch.max(torch.diagonal(K))


def grad_contraction(kern, X: Tensor, lx, ly, sig, Kbar: Tensor) -> Tensor:
    """<Kbar, dK/d(lx, ly, sig)> by autograd of the build, a slab of
    ``ROWS`` points' rows at a time."""
    n = X.shape[0]
    hyp = torch.stack([torch.as_tensor(v, dtype=X.dtype, device=X.device)
                       for v in (lx, ly, sig)]).detach()
    total = torch.zeros(3, dtype=X.dtype, device=X.device)
    for a in range(0, n, ROWS):
        b = min(a + ROWS, n)
        h = hyp.clone().requires_grad_(True)
        with torch.enable_grad():
            qq, qP, Pq, PP = kern.cov_blocks(X[a:b], X, h[0], h[1], h[2])
            s = (torch.sum(qq * Kbar[a:b, :n]) + torch.sum(qP * Kbar[a:b, n:])
                 + torch.sum(Pq * Kbar[n + a:n + b, :n])
                 + torch.sum(PP * Kbar[n + a:n + b, n:]))
            (g,) = torch.autograd.grad(s, h)
        total += g
    return total


def nll_and_grad_theta(kern, X: Tensor, z: Tensor, theta: Tensor, s2n):
    """(NLL, d NLL / d theta) at theta = log10 (lx, ly, sig): the closed
    form 0.5 <Ky^{-1} - alpha alpha^T, dK/dtheta> (Rasmussen & Williams
    5.9) with Ky^{-1} from the Cholesky factor; NaN where it fails."""
    lx, ly, sig = (10.0 ** theta).unbind()
    K = cov(kern, X, X, lx, ly, sig)
    n2 = K.shape[0]
    Ky = K + s2n * torch.eye(n2, dtype=K.dtype, device=K.device)
    del K
    L, info = torch.linalg.cholesky_ex(Ky)
    del Ky
    if int(info) != 0:
        nan = torch.full((), math.nan, dtype=X.dtype, device=X.device)
        return nan, torch.full_like(theta, math.nan)
    alpha = torch.cholesky_solve(z[:, None], L)[:, 0]
    val = 0.5 * z @ alpha + torch.sum(torch.log(torch.diagonal(L)))
    # Ky^{-1} = W^T W with W = L^{-1}, the program's order of work
    W = torch.linalg.solve_triangular(
        L, torch.eye(n2, dtype=L.dtype, device=L.device), upper=False)
    del L
    Kbar = W.mT @ W
    del W
    Kbar.sub_(torch.outer(alpha, alpha)).mul_(0.5)
    g = grad_contraction(kern, X, lx, ly, sig, Kbar)
    return val, g * torch.stack([lx, ly, sig]) * math.log(10.0)


def adam(kern, X: Tensor, z: Tensor, theta0, s2n, steps: int, lr: float):
    """``steps`` Adam iterations (optax's defaults: b1 0.9, b2 0.999, eps
    1e-8; a non-finite gradient counts as zero) over the closed-form
    NLL from log10 ``theta0``.  Returns (theta, NLL history)."""
    theta = torch.as_tensor(np.log10(np.asarray(theta0, np.float64)),
                            dtype=X.dtype, device=X.device)
    mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
    hist = []
    for i in range(steps):
        val, g = nll_and_grad_theta(kern, X, z, theta, s2n)
        g = torch.where(torch.isfinite(g), g, 0.0)
        mu = 0.1 * g + 0.9 * mu
        nu = 0.001 * g**2 + 0.999 * nu
        mhat = mu / (1 - 0.9 ** (i + 1))
        nhat = nu / (1 - 0.999 ** (i + 1))
        theta = theta - lr * mhat / (torch.sqrt(nhat) + 1e-8)
        hist.append(val)
    return theta, torch.stack(hist)


def map_step(model: dict, q: Tensor, p: Tensor, iters: int = 50,
             tol: float = 1e-13, rows: int = 4096):
    """One step of the learned map from (q, p), a (B,) batch, in blocks of
    ``rows``: Newton on P + dg/dq(q, P) - p = 0 from the aux GP's guess
    until every step is below ``tol`` (at most ``iters``), then Q = q +
    dg/dP(q, P), at P wrapped into [0, mod_p) where the model has that
    wrap.  ``model`` holds the kernel ``kern``, X, alpha, lx, ly, sig, the
    aux GP's Xa, alpha_a, alx, aly, asig, and the wraps mod_q and mod_p
    (None for none).  Returns (Q unwrapped, P unwrapped, the last Newton
    step)."""
    kern = model["kern"]
    outs = [(q[:0], q[:0], q[:0])]
    for a in range(0, q.shape[0], rows):
        qb, pb = q[a:a + rows], p[a:a + rows]
        P = pb + kern.aux_mean(model["Xa"], model["alpha_a"], model["alx"],
                               model["aly"], model["asig"], qb, pb)
        step = torch.full_like(P, math.inf)
        for _ in range(iters):
            f, fp, _ = kern.gen_derivs(model["X"], model["alpha"],
                                       model["lx"], model["ly"],
                                       model["sig"], qb, P)
            step = (f - pb + P) / (fp + 1.0)
            P = P - step
            if float(torch.nan_to_num(step.abs(), nan=0.0).max()) < tol * (
                    1.0 + float(torch.nan_to_num(P.abs(), nan=0.0).max())):
                break
        Pw = P if model["mod_p"] is None else torch.remainder(P,
                                                              model["mod_p"])
        _, _, dq = kern.gen_derivs(model["X"], model["alpha"], model["lx"],
                                   model["ly"], model["sig"], qb, Pw)
        outs.append((qb + dq, P, step))
    Q, P, step = (torch.cat(x) for x in zip(*outs))
    return Q, P, step


def rollout(model: dict, q0: Tensor, p0: Tensor, nm: int, iters: int,
            lost=None):
    """``nm`` rows of the map from (q0, p0) with ``iters`` Newton
    iterations a step, in the dtype of the inputs and the model: where
    ``lost(P, q)`` is given, the loss check at the old q (NaN from the step
    that crosses it); Q wrapped into [0, mod_q) and P into [0, mod_p)
    where the model has those wraps.  Returns (Q, P), each (nm, B)."""
    mod_q, mod_p = model["mod_q"], model["mod_p"]
    qs, ps = [q0], [p0]
    q, p = q0, p0
    for _ in range(nm - 1):
        Q, P, _ = map_step(model, q, p, iters=iters, tol=0.0,
                           rows=max(1, q.shape[0]))
        if lost is not None:
            P = torch.where(lost(P, q), math.nan, P)
        if mod_p is not None:
            P = torch.remainder(P, mod_p)
        if mod_q is not None:
            Q = torch.remainder(Q, mod_q)
        Q = torch.where(torch.isnan(P), math.nan, Q)
        qs.append(Q)
        ps.append(P)
        q, p = Q, P
    return torch.stack(qs), torch.stack(ps)
