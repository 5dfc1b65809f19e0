"""CPU baseline with the reference's algorithmic structure.

The reference cannot run here as-is (its kernels are f2py/gfortran modules and
it depends on ghalton/cma; the repo itself records "no significant speedup"
between its Fortran and Python map paths,
``python/05_tokamak/SympGPR/func.py:213``).  This module is a faithful
numpy/scipy re-implementation of its *architecture* for benchmarking:
per-orbit Python loops over map steps, a scipy Newton solve per orbit per
step, and dense Kstar assembly per evaluation
(``python/01_pendulum/implicit/func.py:119-170``,
``python/05_tokamak/SympGPR/func.py:182-211``).  Covariance entries are
numpy-vectorized (faster than the reference's scalar f2py calls), so speedups
measured against this baseline are conservative.

A copy of ``sympgpr_tpu/baselines/reference_cpu.py`` (numpy and scipy
only), kept in the PyTorch port so that the port's benchmark imports no
JAX.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import newton as scipy_newton


def _per_se_hess_blocks(Xa: np.ndarray, Xb: np.ndarray, lx: float, ly: float):
    """All four second-derivative blocks of the periodic x SE kernel between
    point sets Xa (N,2) and Xb (M,2), closed-form (transcribed derivative
    algebra of ``python/05_tokamak/SympGPR/kernels.f90:58-120``)."""
    dq = Xa[:, None, 0] - Xb[None, :, 0]
    dP = Xa[:, None, 1] - Xb[None, :, 1]
    s = np.sin(0.5 * dq) ** 2 / (2 * lx**2)
    k = np.exp(-s - dP**2 / (2 * ly**2))
    sp = np.sin(dq) / (4 * lx**2)
    spp = np.cos(dq) / (4 * lx**2)
    dxdx = (spp - sp**2) * k
    dydy = (1.0 / ly**2 - dP**2 / ly**4) * k
    dxdy = -sp * (dP / ly**2) * k
    return dxdx, dydy, dxdy, k


def build_K(X: np.ndarray, X0: np.ndarray, lx, ly, sig) -> np.ndarray:
    dxdx, dydy, dxdy, _ = _per_se_hess_blocks(X, X0, lx, ly)
    return sig * np.block([[dxdx, dxdy], [dxdy, dydy]])


def build_Kreg(X: np.ndarray, X0: np.ndarray, lx, ly, sig) -> np.ndarray:
    _, _, _, k = _per_se_hess_blocks(X, X0, lx, ly)
    return sig * k


class ReferenceStyleModel:
    """Container mirroring the reference driver state: explicit Kyinv and raw
    training arrays (``python/05_tokamak/SympGPR/main.py:50-78``)."""

    def __init__(self, X, z, lx, ly, sig, sig2n, Xp, zp, lxp, lyp, sigp,
                 aux_delta=True):
        self.X, self.z = np.asarray(X), np.asarray(z)
        self.lx, self.ly, self.sig = float(lx), float(ly), float(sig)
        self.Xp, self.zp = np.asarray(Xp), np.asarray(zp)
        self.lxp, self.lyp, self.sigp = float(lxp), float(lyp), float(sigp)
        self.aux_delta = aux_delta
        K = build_K(self.X, self.X, self.lx, self.ly, self.sig)
        self.Kyinv = np.linalg.inv(K + sig2n * np.eye(K.shape[0]))
        Kp = build_Kreg(self.Xp, self.Xp, self.lxp, self.lyp, self.sigp)
        self.Kyinvp = np.linalg.inv(Kp + sig2n * np.eye(Kp.shape[0]))
        self.Kz = self.Kyinv @ self.z      # hoisted like sympgpr.f90 isn't
        self.Kzp = self.Kyinvp @ self.zp


def guessP(m: ReferenceStyleModel, q, p):
    Kstar = build_Kreg(np.array([[q, p]]), m.Xp, m.lxp, m.lyp, m.sigp)
    mean = float((Kstar @ m.Kzp)[0])
    return p + mean if m.aux_delta else mean


def _dF(m: ReferenceStyleModel, q, P):
    Kstar = build_K(np.array([[q, P]]), m.X, m.lx, m.ly, m.sig)  # (2, 2N)
    out = Kstar @ m.Kz
    return out[0], out[1]  # pGP, dq


def calcP(m: ReferenceStyleModel, q, p, maxiter=50):
    pgss = guessP(m, q, p)

    def f(P):
        return _dF(m, q, P)[0] - p + P

    try:
        return scipy_newton(f, pgss, maxiter=maxiter, disp=False)
    except Exception:
        return np.nan


def applymap(m: ReferenceStyleModel, nm, q0, p0, mod_q=2 * np.pi,
             loss_fn=None):
    """Reference-structure rollout: Python double loop, scipy Newton per
    orbit per step (``applymap_tok``, python/05_tokamak/SympGPR/
    func.py:182-211)."""
    Ntest = len(q0)
    qmap = np.zeros((nm, Ntest))
    pmap = np.zeros((nm, Ntest))
    qmap[0], pmap[0] = q0, p0
    for i in range(nm - 1):
        for k in range(Ntest):
            if np.isnan(pmap[i, k]):
                pmap[i + 1, k] = np.nan
                continue
            pmap[i + 1, k] = calcP(m, qmap[i, k], pmap[i, k])
            if loss_fn is not None and not np.isnan(pmap[i + 1, k]):
                if loss_fn(qmap[i, k], pmap[i + 1, k]):
                    pmap[i + 1, k] = np.nan
        for k in range(Ntest):
            if np.isnan(pmap[i + 1, k]):
                qmap[i + 1, k] = np.nan
            else:
                dq = _dF(m, qmap[i, k], pmap[i + 1, k])[1]
                qmap[i + 1, k] = dq + qmap[i, k]
                if mod_q is not None:
                    qmap[i + 1, k] = np.mod(qmap[i + 1, k], mod_q)
    return qmap, pmap


def tokamak_loss_fn():
    """Numpy twin of the loss-boundary check (func.py:200-203)."""

    def compute_r(pth, th, rstart=0.3):
        r = rstart
        for _ in range(20):
            y = pth - (r**2 / 2.0 - r**3 / 3.0 * np.cos(th))
            dy = -(r - r**2 * np.cos(th))
            r = r - y / dy
        return r

    def loss(q_old, P_new):
        r = compute_r(P_new * 1e-2, q_old)
        return (r > 0.5) or (P_new < 0.0)

    return loss
