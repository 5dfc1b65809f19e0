"""Blocked lower-triangular inversion and Ky^{-1} from a Cholesky factor
(PyTorch port of ``sympgpr_tpu/linalg/triangular.py``).

The closed-form NLL gradient needs ``Kbar = 0.5 (Ky^{-1} - alpha alpha^T)``
(Rasmussen & Williams 5.9).  Ky^{-1} is assembled from matrix products:

* ``tri_inv_blocked``: W = L^{-1} by batched recursive doubling.  All
  ``BASE``-sized diagonal blocks are inverted in one batched
  ``torch.linalg.solve_triangular``; then pairs are combined level by level
  with ``Wb = -Wc (B Wa)``, two batched products with a lower-triangular
  operand, through ``ops.cuda_trimm`` (on a CUDA tensor that is the
  kernel, on a CPU tensor its plain version);
* ``spd_inverse_from_chol``: Ky^{-1} = W^T W through ``ops.cuda_syrk``.
"""

from __future__ import annotations

import torch

from sympgpr_tpu_torch.ops import cuda_syrk, cuda_trimm

Tensor = torch.Tensor

BASE = 512  # size of the diagonal blocks inverted by solve_triangular


def _pad_tri(L: Tensor, m: int) -> Tensor:
    """Pad a lower-triangular factor to (m, m) with an identity tail:
    inv(diag(L, I)) = diag(inv(L), I), so slicing back is exact."""
    n = L.shape[0]
    if m == n:
        return L
    Lp = torch.zeros((m, m), dtype=L.dtype, device=L.device)
    Lp[:n, :n] = L
    tail = torch.arange(n, m, device=L.device)
    Lp[tail, tail] = 1.0
    return Lp


def tri_inv_blocked(L: Tensor) -> Tensor:
    """W = L^{-1} for lower-triangular L by batched recursive doubling.

    Sizes are identity-padded to ``BASE * 2**k`` and the result is sliced
    back.  W is exactly zero above its diagonal.
    """
    n_in = L.shape[0]
    base = min(BASE, max(8, 1 << (n_in - 1).bit_length()))
    m = base
    while m < n_in:
        m *= 2
    L = _pad_tri(L, m)
    nb = m // base

    diag = torch.stack([L[i * base:(i + 1) * base, i * base:(i + 1) * base]
                        for i in range(nb)])
    eye = torch.eye(base, dtype=L.dtype, device=L.device).expand(nb, -1, -1)
    W = torch.linalg.solve_triangular(diag, eye, upper=False)  # (nb, b, b)

    s = base
    while s < m:
        npair = m // (2 * s)
        Wa = W[0::2].contiguous()  # (npair, s, s)
        Wc = W[1::2].contiguous()
        B = torch.stack([L[2 * p * s + s:2 * (p + 1) * s,
                           2 * p * s:2 * p * s + s] for p in range(npair)])
        Wb = -cuda_trimm.matmul_tril_left(
            Wc, cuda_trimm.matmul_tril_right(B, Wa))
        zero = torch.zeros_like(Wa)
        W = torch.cat([torch.cat([Wa, zero], 2), torch.cat([Wb, Wc], 2)], 1)
        s *= 2
    return W[0, :n_in, :n_in]


def spd_inverse_from_chol(L: Tensor) -> Tensor:
    """Ky^{-1} from its lower Cholesky factor: W = L^{-1}, then W^T W."""
    W = tri_inv_blocked(L).contiguous()
    return cuda_syrk.syrk_lower(W)
