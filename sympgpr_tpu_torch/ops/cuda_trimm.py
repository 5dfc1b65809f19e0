"""Batched matmul with one lower-triangular operand (PyTorch port of
``sympgpr_tpu/ops/pallas_trimm.py``).

The blocked triangular inverse (``linalg/triangular.py``) spends its
multiply-adds in two batched products per level, B @ Wa and Wc @ (B Wa),
with Wa and Wc lower-triangular.  The hand-written CUDA kernel
(``csrc/tri_matmul.cu``, replacing the Pallas kernel ``_trimm_tile``) skips
the structural zeros and never reads the triangular operand above its
diagonal.  CPU tensors run the plain version, ``torch.tril`` then
``torch.matmul``; CUDA tensors launch the kernel or raise.  ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from sympgpr_tpu_torch.ops import _build

Tensor = torch.Tensor

LAUNCHES = 0  # kernel launches made by the wrappers in this process

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def matmul_tril_right_reference(A: Tensor, L: Tensor) -> Tensor:
    """Plain version: A @ tril(L)."""
    return torch.matmul(A, torch.tril(L))


def matmul_tril_left_reference(L: Tensor, A: Tensor) -> Tensor:
    """Plain version: tril(L) @ A."""
    return torch.matmul(torch.tril(L), A)


def _check(A: Tensor, B: Tensor) -> None:
    if A.ndim != 3 or A.shape != B.shape or A.shape[1] != A.shape[2]:
        raise ValueError(f"trimm operands must be equal (nb, s, s); got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")


def _launch(A: Tensor, B: Tensor, right: bool) -> Tensor:
    global LAUNCHES
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"trimm kernel takes float32 or float64, not "
                        f"{A.dtype}")
    if B.dtype != A.dtype or B.device != A.device:
        raise ValueError(f"trimm operands must share dtype and device; got "
                         f"{A.dtype} on {A.device}, {B.dtype} on {B.device}")
    if not (A.is_contiguous() and B.is_contiguous()):
        raise ValueError("trimm kernel operands must be contiguous")
    nb, s, _ = A.shape
    C = torch.empty_like(A)
    sym = "trimm_f32" if A.dtype == torch.float32 else "trimm_f64"
    fn = _build.function("tri_matmul", sym, _ARGS)
    with torch.cuda.device(A.device):
        rc = fn(_build.ptr(A), _build.ptr(B), _build.ptr(C), nb, s,
                int(right), _build.stream(A.device))
    _build.check(rc, "trimm")
    LAUNCHES += 1
    return C


def _dispatch(A: Tensor, B: Tensor, right: bool) -> Tensor:
    _check(A, B)
    if A.device.type == "cpu":
        return (matmul_tril_right_reference(A, B) if right
                else matmul_tril_left_reference(A, B))
    if A.device.type != "cuda":
        raise ValueError(f"no trimm for device {A.device}")
    return _launch(A, B, right)


def matmul_tril_right(A: Tensor, L: Tensor) -> Tensor:
    """Batched A @ L with L lower-triangular: (nb, s, s) x (nb, s, s).

    Any ``s`` (the kernel masks its ragged edge); L is never read above
    its diagonal, so it may hold anything there.
    """
    return _dispatch(A, L, True)


def matmul_tril_left(L: Tensor, A: Tensor) -> Tensor:
    """Batched L @ A with L lower-triangular (as ``matmul_tril_right``)."""
    return _dispatch(L, A, False)
