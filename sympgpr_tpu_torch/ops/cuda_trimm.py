"""Batched matmul with one lower-triangular operand (PyTorch port of
``sympgpr_tpu/ops/pallas_trimm.py``).

The blocked triangular inverse (``linalg/triangular.py``) spends its
multiply-adds in two batched products per level, B @ Wa and Wc @ (B Wa),
with Wa and Wc lower-triangular.  The hand-written CUDA kernel
(``csrc/tri_matmul.cu``, replacing the Pallas kernel ``_trimm_tile``) skips
the structural zeros and never reads the triangular operand above its
diagonal.  Operands may be strided views (rows contiguous, any row and
batch stride), the result may be written into a view (``out``), and a
``sign`` of -1 negates it in the kernel's epilogue, so the inverse keeps
one buffer.  CPU tensors run the plain version, ``torch.tril`` then
``torch.matmul``; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from sympgpr_tpu_torch.ops import _build
from sympgpr_tpu_torch.profiling import count

Tensor = torch.Tensor

# (pointer, row stride, batch stride) for A, B and C; nb, s, right, sign;
# the stream
_ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 3
         + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def matmul_tril_right_reference(A: Tensor, L: Tensor) -> Tensor:
    """Plain version: A @ tril(L)."""
    return torch.matmul(A, torch.tril(L))


def matmul_tril_left_reference(L: Tensor, A: Tensor) -> Tensor:
    """Plain version: tril(L) @ A."""
    return torch.matmul(torch.tril(L), A)


def _check(A: Tensor, B: Tensor, out: Tensor | None, sign: int) -> None:
    if A.ndim != 3 or A.shape != B.shape or A.shape[1] != A.shape[2]:
        raise ValueError(f"trimm operands must be equal (nb, s, s); got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    if out is not None and out.shape != A.shape:
        raise ValueError(f"trimm out must be {tuple(A.shape)}; got "
                         f"{tuple(out.shape)}")
    if sign not in (1, -1):
        raise ValueError(f"trimm sign must be 1 or -1; got {sign}")


def _launch(A: Tensor, B: Tensor, C: Tensor, right: bool,
            sign: int) -> None:
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"trimm kernel takes float32 or float64, not "
                        f"{A.dtype}")
    for X in (B, C):
        if X.dtype != A.dtype or X.device != A.device:
            raise ValueError(
                f"trimm operands must share dtype and device; got "
                f"{A.dtype} on {A.device}, {X.dtype} on {X.device}")
    if any(X.stride(2) != 1 for X in (A, B, C)):
        raise ValueError("trimm kernel operands must have contiguous rows")
    nb, s, _ = A.shape
    sym = "trimm_f32" if A.dtype == torch.float32 else "trimm_f64"
    fn = _build.function("tri_matmul", sym, _ARGS)
    args = []
    for X in (A, B, C):
        args += [_build.ptr(X), X.stride(1), X.stride(0)]
    with torch.cuda.device(A.device):
        rc = fn(*args, nb, s, int(right), sign, _build.stream(A.device))
    _build.check(rc, "trimm")
    count("trimm")


def _dispatch(A: Tensor, B: Tensor, right: bool, out: Tensor | None,
              sign: int) -> Tensor:
    _check(A, B, out, sign)
    if A.device.type == "cpu":
        C = (matmul_tril_right_reference(A, B) if right
             else matmul_tril_left_reference(A, B))
        if sign < 0:
            C = C.neg()
        return C if out is None else out.copy_(C)
    if A.device.type != "cuda":
        raise ValueError(f"no trimm for device {A.device}")
    C = torch.empty_like(A, memory_format=torch.contiguous_format) \
        if out is None else out
    if A.numel():
        _launch(A, B, C, right, sign)
    return C


def matmul_tril_right(A: Tensor, L: Tensor, out: Tensor | None = None,
                      sign: int = 1) -> Tensor:
    """Batched ``sign * (A @ L)`` with L lower-triangular: (nb, s, s) x
    (nb, s, s).

    Any ``s`` (the kernel masks its ragged edge); L is never read above
    its diagonal, so it may hold anything there.  Operands may be views
    with contiguous rows; the result goes to ``out`` (such a view, not
    overlapping A or L) when given, else to a new tensor.
    """
    return _dispatch(A, L, True, out, sign)


def matmul_tril_left(L: Tensor, A: Tensor, out: Tensor | None = None,
                     sign: int = 1) -> Tensor:
    """Batched ``sign * (L @ A)`` with L lower-triangular (as
    ``matmul_tril_right``)."""
    return _dispatch(L, A, False, out, sign)
