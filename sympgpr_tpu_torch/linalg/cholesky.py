"""Distributed Cholesky factorization (PyTorch port of
``sympgpr_tpu/linalg/cholesky.py``).

``distributed_cholesky`` runs the right-looking block-cyclic algorithm of
``distributed/large.py`` over the ranks of a mesh axis: block rows are
dealt out cyclically, the diagonal block goes out from its owner by one
broadcast a step, every rank factors it, solves its own panel rows and
takes part in one all-gather of the panel column for the trailing update.
Exact (no iterative refinement); non-divisible sizes are padded with an
identity tail (``pad_spd``).  On one device ``torch.linalg.cholesky`` is
the factorization: this path exists for matrices that outgrow one card.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

Tensor = torch.Tensor


def pad_spd(K: Tensor, multiple: int) -> Tensor:
    """Pad an SPD matrix to the next multiple with an identity tail.

    ``chol(diag(K, I)) = diag(chol(K), I)``, so factoring the padded
    matrix and slicing back ``[:n, :n]`` is exact; padded solve inputs are
    zero-extended and padded log-determinant terms vanish.
    """
    n = K.shape[0]
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return K
    Kp = torch.nn.functional.pad(K, (0, n_pad - n, 0, n_pad - n))
    tail = torch.arange(n, n_pad, device=K.device)
    Kp[tail, tail] = 1.0
    return Kp


def distributed_cholesky(K: Tensor, mesh: DeviceMesh, axis: str = "kp",
                         block: int | None = None) -> Tensor:
    """Lower Cholesky factor with block rows cyclic over ``axis``.

    K: (n, n), the same on every rank; returns the factor L, the same on
    every rank (gathered after the factorization).  During it each rank
    holds n/(D*block) block rows; per step one broadcast of the diagonal
    block and one all-gather of the panel column cross the group.  The
    training path that never holds K whole is ``distributed.large``.
    """
    from sympgpr_tpu_torch.distributed.init import all_gather, axis_group
    from sympgpr_tpu_torch.distributed.large import _factorize_cyclic

    n_in = K.shape[0]
    group, d, D = axis_group(mesh, axis)
    if block is None:
        block = max(8, n_in // (4 * D))
    K = pad_spd(K, block * D)
    n = K.shape[0]
    nb = n // block
    nb_loc = nb // D
    local = K.reshape(nb, block, n)[d::D]  # block rows l*D + d
    Lc, _ = _factorize_cyclic(local, None, d, group, D, nb, nb_loc, block)
    full = all_gather(Lc, group)  # (D, nb_loc, block, n): cyclic layout
    L = full.transpose(0, 1).reshape(n, n)
    return torch.tril(L)[:n_in, :n_in]
