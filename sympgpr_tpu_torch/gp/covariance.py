"""Covariance assembly for derivative-observation GPs (PyTorch port).

Counterpart of ``sympgpr_tpu/gp/covariance.py``.  Layout contract (the
target vector is ``z = (z_p | z_q) = (p - P | Q - q)``):

  ``K[r*N + i, c*N0 + j] = sig * d^2 k / du_r dv_c (u_i, v_j)``

with ``u_i`` the row points, ``v_j`` the column points, component 0 = q and
component 1 = P.
"""

from __future__ import annotations

import torch
from torch.func import vmap

from sympgpr_tpu_torch.kernels.variants import Kernel

Tensor = torch.Tensor


def hess_blocks(kernel: Kernel, X: Tensor, X0: Tensor,
                params: Tensor) -> Tensor:
    """(N, N0, 2, 2) array of Hessian blocks H[i,j,r,c] = d2k/du_r dv_c."""
    return vmap(
        lambda u: vmap(lambda v: kernel.hess_uv(u, v, params))(X0)
    )(X)


def build_K(kernel: Kernel, X: Tensor, X0: Tensor, params: Tensor,
            sig: Tensor) -> Tensor:
    """Derivative-observation covariance, shape (2N, 2N0), by autodiff."""
    N, N0 = X.shape[0], X0.shape[0]
    H = hess_blocks(kernel, X, X0, params)
    K = H.permute(2, 0, 3, 1).reshape(2 * N, 2 * N0)
    return sig * K


def build_Kreg(kernel: Kernel, X: Tensor, X0: Tensor, params: Tensor,
               sig: Tensor) -> Tensor:
    """Plain (N, N0) kernel matrix for the auxiliary ordinary GP."""
    K = vmap(lambda u: vmap(lambda v: kernel.fn(u, v, params))(X0))(X)
    return sig * K


def product_blocks(kernel: Kernel, X: Tensor, X0: Tensor, params: Tensor):
    """(dxdx, dxdy, dydy), each (..., N, N0) without sig, for a product
    kernel A(dq) * B(dP) (``Kernel.product``), from the shared factors of
    ``kernel.q_factors``; leading batch dims broadcast."""
    ly = params[1]
    dq = X[..., :, None, 0] - X0[..., None, :, 0]
    dP = X[..., :, None, 1] - X0[..., None, :, 1]
    A, sp, spp = kernel.q_factors(dq, params)
    B = torch.exp(-(dP**2) / (2.0 * ly**2))
    ily2 = 1.0 / ly**2
    AB = A * B
    return ((spp - sp**2) * AB, -sp * dP * ily2 * AB,
            (ily2 - dP**2 * ily2**2) * AB)


def build_K_fast(kernel: Kernel, X: Tensor, X0: Tensor, params: Tensor,
                 sig: Tensor) -> Tensor:
    """Closed-form covariance for product kernels A(dq) * B(dP).

    All four blocks come from ``product_blocks``; kernels outside the
    product family use ``build_K``.  Leading batch dims broadcast: X
    (..., N, 2), X0 (..., N0, 2), each of ``params[i]`` and sig of shape
    (..., 1, 1) give (..., 2N, 2N0) (``likelihood.nll_batched``).
    """
    if not kernel.product:
        return build_K(kernel, X, X0, params, sig)
    dxdx, dxdy, dydy = product_blocks(kernel, X, X0, params)
    return sig * torch.cat([torch.cat([dxdx, dxdy], -1),
                            torch.cat([dxdy, dydy], -1)], -2)



def pack_points(q: Tensor, P: Tensor) -> Tensor:
    """Stack coordinate arrays (N,) + (N,) -> (N, 2) points."""
    return torch.stack([q, P], dim=-1)


def unpack_flat(x: Tensor) -> Tensor:
    """Convert the reference's flat ``hstack((q, P))`` layout to (N, 2)."""
    n = x.shape[0] // 2
    return torch.stack([x[:n], x[n:]], dim=-1)
