"""Sobol sensitivity analysis over system parameters (PyTorch port of
``sympgpr_tpu/sensitivity.py``).

Saltelli's estimator for first-order and total-effect indices.  The
quantity of interest is a batched callable ``(B, d) -> (B,)``, evaluated
once over the whole ((d + 2) n, d) design on the design's device.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from sympgpr_tpu_torch.systems import tokamak as tk
from sympgpr_tpu_torch.systems.halton import halton

Tensor = torch.Tensor


def saltelli_sample(n: int, bounds: Sequence[tuple[float, float]],
                    seed: int = 0) -> np.ndarray:
    """((d+2)*n, d) Saltelli design from two quasi-random matrices A, B
    (the Halton sequence is deterministic: ``seed`` is unused, as in the
    JAX package)."""
    d = len(bounds)
    U = halton(2 * n, 2 * d)
    A = U[:n, :d]
    B = U[:n, d:]
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])

    def scale(M):
        return lo + M * (hi - lo)

    mats = [scale(A), scale(B)]
    for i in range(d):
        ABi = A.copy()
        ABi[:, i] = B[:, i]
        mats.append(scale(ABi))
    return np.concatenate(mats, axis=0)


def sobol_indices(
    qoi: Callable[[Tensor], Tensor],
    bounds: Sequence[tuple[float, float]],
    n: int = 256,
    seed: int = 0,
    *,
    device: torch.device | str,
    dtype: torch.dtype = torch.float64,
):
    """First-order S1 and total-effect ST indices of ``qoi`` over
    ``bounds``, and the variance of f over A and B (numpy)."""
    d = len(bounds)
    X = torch.as_tensor(saltelli_sample(n, bounds, seed), dtype=dtype,
                        device=device)
    Y = qoi(X).cpu().numpy().astype(np.float64)
    fA = Y[:n]
    fB = Y[n : 2 * n]
    var = np.var(np.concatenate([fA, fB]))
    S1 = np.zeros(d)
    ST = np.zeros(d)
    for i in range(d):
        fABi = Y[(2 + i) * n : (3 + i) * n]
        S1[i] = np.mean(fB * (fABi - fA)) / var
        ST[i] = 0.5 * np.mean((fA - fABi) ** 2) / var
    return S1, ST, var


def tokamak_chaos_qoi(n_turns: int = 30, nph: int = 32, r0: float = 0.2,
                      th0: float = 1.0) -> Callable[[Tensor], Tensor]:
    """QoI: radial excursion of a field line after ``n_turns`` turns as a
    function of (eps, phase), one row each: measures island/chaos
    strength.

    All rows integrate together through ``systems/tokamak.py``'s midpoint
    step with a (B,) field (eps, phase per row; m = -3, n = 2): six Newton
    iterations a step on the exact Jacobian of the residual through
    ``compute_r`` (``_tstep_jacobian``), then r at the new point.
    """

    def qoi(theta: Tensor) -> Tensor:
        field = tk.TokamakField(eps=theta[:, 0], phase=theta[:, 1])
        dph = 2.0 * math.pi / nph
        r = torch.full_like(theta[:, 0], r0)
        th = torch.full_like(r, th0)
        z = torch.stack([tk.Ath(r, th, 0.0), th, torch.zeros_like(r)], -1)
        lo = torch.full_like(r, math.inf)
        hi = torch.full_like(r, -math.inf)
        for _ in range(nph * n_turns):
            z, r = tk.timestep(field, dph, z, r, newton_iters=6)
            rr = tk.compute_r(z[:, 0], z[:, 1], z[:, 2], r)
            lo, hi = torch.minimum(lo, rr), torch.maximum(hi, rr)
        return hi - lo

    return qoi
