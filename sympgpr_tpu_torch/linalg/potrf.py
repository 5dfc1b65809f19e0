"""The large-N fit step's Cholesky factor of Ky, written over Ky itself.

``torch.linalg.cholesky_ex`` on a CUDA matrix copies it into a new
column-major buffer, runs cuSOLVER's potrf there and masks the other
triangle; a blocked inverse of that L then copies it back to row-major.
On an (8192, 8192) float32 Ky those copies and the mask move 1.6 GB and
compute nothing.  ``cholesky_in_place`` factors Ky in its own buffer by
the hand-written blocked Cholesky of ``csrc/tri_matmul.cu``
(``potrf_diag``, ``potrf_panel_kernel``, ``potrf_update_kernel``): L lands
row-major over Ky's lower triangle, the triangle ``cholesky_ex`` reads,
and Ky's strict upper triangle is left as it was.  The JAX package
factors with ``jnp.linalg.cholesky``; no Pallas kernel has this role.

The algorithm, right-looking over block columns of 128: factor the
diagonal block, solve the rows below it against that factor (the panel
L_i = A_i L_kk^-T), update the lower tiles of the trailing matrix
(A_ij -= L_i L_j^T).  The panel is kept in float64 beside L, and the
products and sums of the update are float64 (the float64 tensor cores
on the card), rounded to Ky's dtype once an update: cuSOLVER's float32
factor summed in float32 and set the float32 fit's gradient error
(``tools/large_n_grad_witness.py``).  ``potrf_lower_reference`` is the
same algorithm in plain PyTorch, in the same block order.

Any other input than a non-empty square contiguous CUDA matrix of
float32 or float64 (a CPU tensor, a batch, a view) takes
``torch.linalg.cholesky_ex`` and leaves Ky as it was.
"""

from __future__ import annotations

import ctypes

import torch

from sympgpr_tpu_torch.ops import _build
from sympgpr_tpu_torch.profiling import count

Tensor = torch.Tensor

BLOCK = 128  # block column width, the kernel's kPB
_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p]


def potrf_lower_reference(A: Tensor, block: int = BLOCK,
                          acc: torch.dtype = torch.float64
                          ) -> tuple[Tensor, int]:
    """Plain version, written over A: (A, info) with the Cholesky factor
    in A's lower triangle and its strict upper triangle untouched.

    Block column k0: the factor of the diagonal block (``cholesky_ex`` in
    ``acc`` on the updated block, before it is rounded), the panel below it
    by a triangular solve in ``acc``, the trailing matrix's lower triangle
    less the panel's product in ``acc``, each rounded to A's dtype once.
    info is 0, or the order of the first failing leading minor; the factor
    goes on past a failure as the kernel does.  ``acc=torch.float32``
    gives the same blocks with float32 sums.
    """
    n = A.shape[0]
    info = 0
    D = A[:min(block, n), :min(block, n)].to(acc)
    for k0 in range(0, n, block):
        w = min(block, n - k0)
        Lkk, fail = torch.linalg.cholesky_ex(D)
        if int(fail) and not info:
            info = k0 + int(fail)
        diag = A[k0:k0 + w, k0:k0 + w]
        low = torch.tril(torch.ones_like(diag, dtype=torch.bool))
        diag.copy_(torch.where(low, Lkk.to(A.dtype), diag))
        if k0 + w == n:
            break
        rest = slice(k0 + w, n)
        panel = torch.linalg.solve_triangular(
            Lkk, A[rest, k0:k0 + w].to(acc).T, upper=False).T
        A[rest, k0:k0 + w] = panel.to(A.dtype)
        trail = A[rest, rest].to(acc) - panel @ panel.T
        w1 = min(block, n - k0 - w)
        D = trail[:w1, :w1]
        low = torch.tril(torch.ones_like(trail, dtype=torch.bool))
        A[rest, rest] = torch.where(low, trail.to(A.dtype), A[rest, rest])
    return A, info


def _factor_on_card(Ky: Tensor) -> tuple[Tensor, Tensor]:
    n = Ky.shape[0]
    sym = "potrf_lower_f32" if Ky.dtype == torch.float32 \
        else "potrf_lower_f64"
    fn = _build.function("tri_matmul", sym, _ARGS)
    size = _build.function("tri_matmul", "potrf_work_doubles",
                           [ctypes.c_int])
    work = torch.empty(size(n), dtype=torch.float64, device=Ky.device)
    info = torch.empty((), dtype=torch.int32, device=Ky.device)
    with torch.cuda.device(Ky.device):
        rc = fn(_build.ptr(Ky), n, _build.ptr(work), _build.ptr(info),
                _build.stream(Ky.device))
    _build.check(rc, "potrf")
    count("potrf")
    return Ky, info


def cholesky_in_place(Ky: Tensor) -> tuple[Tensor, Tensor]:
    """(L, info) for a symmetric positive definite Ky, as
    ``torch.linalg.cholesky_ex(Ky)`` gives them: info is 0 on success and
    i > 0 where the leading minor of order i is not positive definite
    (its pivot not positive or not finite).

    On a non-empty square contiguous CUDA matrix of float32 or float64 the
    factor is written over Ky's lower triangle by the kernel and L is Ky
    itself, row-major: its strict upper triangle still holds Ky's entries
    (read L's lower triangle only), and info is a device int32 scalar,
    with no host sync.  A failed factor may leave NaN below the failing
    column.  Every other input takes ``torch.linalg.cholesky_ex`` and
    leaves Ky as it was.
    """
    if (Ky.is_cuda and Ky.ndim == 2 and Ky.shape[0] == Ky.shape[1]
            and Ky.numel() > 0 and Ky.is_contiguous()
            and Ky.dtype in (torch.float32, torch.float64)):
        return _factor_on_card(Ky)
    return torch.linalg.cholesky_ex(Ky)
