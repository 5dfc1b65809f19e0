"""y = S x for a square S: the large-N fit step's alpha = Ky^{-1} z from
the S = Ky^{-1} that the step forms for its gradient
(``gp/likelihood.py::nll_value_and_grad``).

No TPU kernel has this role: the JAX package solves for alpha with two
triangular solves.  On the card those are cuBLAS's trsv, a chain of blocks
down the diagonal that leaves the card idle; the product reads S once with
no chain.  The hand-written CUDA kernel (``csrc/tri_matmul.cu``,
``matvec_kernel``) multiplies and sums in float64, rounds to S's dtype
once, and sums each row in one fixed order, so two calls give the same
bits.  CPU tensors run the plain version ``S @ x`` in float64; CUDA tensors
launch the kernel or raise.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from sympgpr_tpu_torch.ops import _build

Tensor = torch.Tensor

LAUNCHES = 0  # kernel launches made by matvec in this process

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]


def matvec_reference(S: Tensor, x: Tensor) -> Tensor:
    """Plain version: S @ x in float64, rounded to S's dtype."""
    return (S.double() @ x.double()).to(S.dtype)


def _launch(S: Tensor, x: Tensor) -> Tensor:
    global LAUNCHES
    if S.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"matvec kernel takes float32 or float64, not "
                        f"{S.dtype}")
    if not (S.is_contiguous() and x.is_contiguous()):
        raise ValueError("matvec kernel inputs must be contiguous")
    n = S.shape[0]
    y = torch.empty_like(x)
    sym = "matvec_f32" if S.dtype == torch.float32 else "matvec_f64"
    fn = _build.function("tri_matmul", sym, _ARGS)
    with torch.cuda.device(S.device):
        rc = fn(_build.ptr(S), _build.ptr(x), _build.ptr(y), n,
                _build.stream(S.device))
    _build.check(rc, "matvec")
    LAUNCHES += 1
    return y


def matvec(S: Tensor, x: Tensor) -> Tensor:
    """y = S x for a square (n, n) S and an (n,) x of S's dtype and
    device."""
    if S.ndim != 2 or S.shape[0] != S.shape[1] or S.shape[0] == 0:
        raise ValueError(f"matvec takes a non-empty square matrix; got "
                         f"{tuple(S.shape)}")
    if x.shape != S.shape[:1] or x.dtype != S.dtype \
            or x.device != S.device:
        raise ValueError(f"matvec takes x of shape ({S.shape[0]},), "
                         f"{S.dtype} on {S.device}; got {tuple(x.shape)}, "
                         f"{x.dtype} on {x.device}")
    if S.device.type == "cpu":
        return matvec_reference(S, x)
    if S.device.type != "cuda":
        raise ValueError(f"no matvec for device {S.device}")
    return _launch(S, x)
