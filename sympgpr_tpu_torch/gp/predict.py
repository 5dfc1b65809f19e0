"""Posterior mean and variance prediction (PyTorch port of
``sympgpr_tpu/gp/predict.py``).

With the Cholesky factor L of K + sig2n I stored on the fitted model, the
predictive variance of each derivative component at a test point v is
``k**(v, v) - ||L^-1 k*(v)||^2``.  All test points are handled as one
batch: the cross-covariance of M points is one (2N, 2M) block of the
derivative-observation covariance (``gp/covariance.py``).
"""

from __future__ import annotations

import torch
from torch.func import vmap

from sympgpr_tpu_torch.gp.covariance import build_K, build_Kreg
from sympgpr_tpu_torch.gp.model import AuxGP, SympGP

Tensor = torch.Tensor


def _kstar_deriv(sgp: SympGP, V: Tensor) -> Tensor:
    """(2N, 2M) cross-covariance between the training derivative
    observations (rows ``r*N + i``) and the two derivative components of
    the M test points V (M, 2) (columns ``c*M + j``); for one point, the
    JAX package's (2N, 2) columns."""
    return build_K(sgp.kernel, sgp.X, V, sgp.params, sgp.sig)


def _check_factor(model: SympGP | AuxGP) -> None:
    if model.L.shape[0] == 0:
        raise ValueError(
            "posterior variance unavailable: this model was fitted "
            "without a dense Cholesky factor (the large-N fit keeps none). "
            "Use predict_df(..., with_var=False) for means only, or refit "
            "with SympGP.create.")


def predict_df(sgp: SympGP, V: Tensor, with_var: bool = True):
    """Posterior of (dF/dq, dF/dP) = (p - P, Q - q) at test points V (M, 2).

    Returns (mean (M, 2), var (M, 2) or None).
    """
    if with_var:
        _check_factor(sgp)
    M = V.shape[0]
    Ks = _kstar_deriv(sgp, V)
    means = (sgp.alpha @ Ks).reshape(2, M).T
    if not with_var:
        return means, None
    prior = sgp.sig * vmap(
        lambda v: torch.diagonal(sgp.kernel.hess_uv(v, v, sgp.params)))(V)
    W = torch.linalg.solve_triangular(sgp.L, Ks, upper=False)
    var = prior - torch.sum(W * W, dim=0).reshape(2, M).T
    return means, torch.clamp(var, min=0.0)


def predict_aux(aux: AuxGP, V: Tensor, with_var: bool = True):
    """Posterior of the auxiliary GP target at test points V (M, 2).

    Returns (mean (M,), var (M,) or None).
    """
    if with_var:
        _check_factor(aux)
    kvec = build_Kreg(aux.kernel, aux.X, V, aux.params, aux.sig)  # (N, M)
    means = aux.alpha @ kvec
    if not with_var:
        return means, None
    prior = aux.sig * vmap(lambda v: aux.kernel.fn(v, v, aux.params))(V)
    w = torch.linalg.solve_triangular(aux.L, kvec, upper=False)
    return means, torch.clamp(prior - torch.sum(w * w, dim=0), min=0.0)
