"""Blocked lower-triangular inversion and Ky^{-1} from a Cholesky factor
(PyTorch port of ``sympgpr_tpu/linalg/triangular.py``).

The closed-form NLL gradient needs ``Kbar = 0.5 (Ky^{-1} - alpha alpha^T)``
(Rasmussen & Williams 5.9).  Ky^{-1} is assembled from matrix products:

* ``tri_inv_blocked``: W = L^{-1} by batched recursive doubling in one
  (m, m) buffer.  All ``BASE``-sized diagonal blocks are inverted in one
  batched ``torch.linalg.solve_triangular``; then pairs are combined level
  by level with ``Wb = -Wc (B Wa)``, two batched products with a
  lower-triangular operand on strided views of W and L, through
  ``ops.cuda_trimm`` (on a CUDA tensor that is the kernel, on a CPU tensor
  its plain version);
* ``spd_inverse_from_chol``: Ky^{-1} = W^T W through ``ops.cuda_syrk``.
"""

from __future__ import annotations

import torch

from sympgpr_tpu_torch.ops import cuda_syrk, cuda_trimm
from sympgpr_tpu_torch.profiling import span

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


def _blocks(X: Tensor, count: int, size: int, step: int, row: int = 0,
            col: int = 0) -> Tensor:
    """``count`` (size, size) blocks of the contiguous square X as one
    strided view: block p starts at (row + p step, col + p step)."""
    m = X.shape[0]
    return X.as_strided((count, size, size), (step * (m + 1), m, 1),
                        X.storage_offset() + row * m + col)


def tri_inv_blocked(L: Tensor) -> Tensor:
    """W = L^{-1} for lower-triangular L by batched recursive doubling.

    Sizes are identity-padded to ``BASE * 2**k`` and the result is sliced
    back.  W is one (m, m) buffer, exactly zero above its diagonal: each
    level reads its diagonal blocks Wa, Wc and L's subdiagonal blocks B as
    strided views, and the second product writes -Wc (B Wa) straight into
    W's subdiagonal blocks.
    """
    n_in = L.shape[0]
    base = min(BASE, max(8, 1 << (n_in - 1).bit_length()))
    m = base
    while m < n_in:
        m *= 2
    L = _pad_tri(L, m).contiguous()
    nb = m // base

    W = torch.zeros_like(L)
    eye = torch.eye(base, dtype=L.dtype, device=L.device).expand(nb, -1, -1)
    _blocks(W, nb, base, base).copy_(torch.linalg.solve_triangular(
        _blocks(L, nb, base, base), eye, upper=False))

    s = base
    while s < m:
        npair, step = m // (2 * s), 2 * s
        BWa = cuda_trimm.matmul_tril_right(_blocks(L, npair, s, step, s, 0),
                                           _blocks(W, npair, s, step))
        cuda_trimm.matmul_tril_left(_blocks(W, npair, s, step, s, s), BWa,
                                    out=_blocks(W, npair, s, step, s, 0),
                                    sign=-1)
        s *= 2
    return W[:n_in, :n_in]


def spd_inverse_from_chol(L: Tensor) -> Tensor:
    """Ky^{-1} from its lower Cholesky factor: W = L^{-1}, then W^T W."""
    with span("sympgpr::linalg.tri_inv"):
        W = tri_inv_blocked(L).contiguous()
    with span("sympgpr::linalg.syrk"):
        return cuda_syrk.syrk_lower(W)
