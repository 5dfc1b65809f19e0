"""S = W^T W for a lower-triangular W (PyTorch port of
``sympgpr_tpu/ops/pallas_syrk.py``).

Used by ``linalg.triangular.spd_inverse_from_chol`` to form Ky^{-1} = W^T W
from W = L^{-1} for the closed-form NLL gradient.  The hand-written CUDA
kernel (``csrc/tri_matmul.cu``, replacing the Pallas kernel ``_syrk_tile``)
computes only the lower tiles, accumulates only the k-range where W is not
zero, never reads W above its diagonal, and writes each tile's mirror too.
It converts float32 input to float64 and multiplies and sums on the float64
tensor cores: a float32 accumulation drove the Adam fit at N = 4096 into a
jitter escalation (``csrc/tri_matmul.cu``).
CPU tensors run the plain version ``W.T @ W``; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from sympgpr_tpu_torch.ops import _build
from sympgpr_tpu_torch.profiling import count

Tensor = torch.Tensor

_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]


def syrk_lower_reference(W: Tensor) -> Tensor:
    """Plain version: W.T @ W."""
    return W.T @ W


def _launch(W: Tensor) -> Tensor:
    if W.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"syrk kernel takes float32 or float64, not "
                        f"{W.dtype}")
    if not W.is_contiguous():
        raise ValueError("syrk kernel input must be contiguous")
    n = W.shape[0]
    S = torch.empty_like(W)
    sym = "syrk_lower_f32" if W.dtype == torch.float32 else "syrk_lower_f64"
    fn = _build.function("tri_matmul", sym, _ARGS)
    with torch.cuda.device(W.device):
        rc = fn(_build.ptr(W), _build.ptr(S), n, _build.stream(W.device))
    _build.check(rc, "syrk")
    count("syrk")
    return S


def syrk_lower(W: Tensor) -> Tensor:
    """Full symmetric S = W^T W for a lower-triangular (n, n) W."""
    if W.ndim != 2 or W.shape[0] != W.shape[1] or W.shape[0] == 0:
        raise ValueError(f"syrk takes a non-empty square matrix; got "
                         f"{tuple(W.shape)}")
    if W.device.type == "cpu":
        return syrk_lower_reference(W)
    if W.device.type != "cuda":
        raise ValueError(f"no syrk for device {W.device}")
    return _launch(W)
