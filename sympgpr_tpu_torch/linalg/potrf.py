"""The large-N fit step's Cholesky factor of Ky, written over Ky itself.

``torch.linalg.cholesky_ex`` on a CUDA matrix copies it into a new
column-major buffer, runs cuSOLVER's potrf with the lower fill mode there
and masks the other triangle: on an (8192, 8192) float32 Ky the copy and
the mask move 1.1 GB, take ~1.2 ms and compute nothing.

Ky is symmetric, so its row-major bytes read as a column-major matrix are
Ky as well.  ``cholesky_in_place`` runs the same routine,
``cusolverDnXpotrf`` with the lower fill mode, on Ky's own buffer read
column-major.  It reads the elements (i >= j) column-major, which are the
elements (row <= col) row-major, and writes L there.  Read row-major the
buffer holds U = L^T above its diagonal, so its transposed view
``Ky.mT`` is L in the layout ``cholesky_ex`` returns (column-major), and
the blocked inverse's one copy to row-major stays.  The factor is of Ky's
upper triangle where ``cholesky_ex``'s is of its lower one: the same
numbers where Ky is symmetric to the bit, and where it is not (the fit's
covariance build rounds its two triangles apart) a factor of the same
matrix to rounding.  The other triangle of the buffer keeps Ky's entries:
callers read the lower triangle of L only.

The upper fill mode on the same buffer would land L row-major and spare
that copy too, but cuSOLVER runs it 5 ms slower at n = 8192 float32
(12.89 against 7.86 ms on an H100), more than the copy's 0.6 ms.

cuSOLVER is the library PyTorch's linear algebra has already loaded into
the process, found by its path in the process's memory map and called
through ``ctypes`` on PyTorch's current stream, with its workspace from
the caching allocator and ``info`` left on the device (no host read).  One
handle a device is made on first use.  Any other input (a CPU tensor, a
batch, a non-contiguous view, another dtype) takes
``torch.linalg.cholesky_ex``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from sympgpr_tpu_torch.profiling import count

Tensor = torch.Tensor

_FILL_LOWER = 0  # cublasFillMode_t: CUBLAS_FILL_MODE_LOWER
_DATA_TYPE = {torch.float32: 0, torch.float64: 1}  # CUDA_R_32F, CUDA_R_64F
_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "cusolverDnCreate": [_VP],
    "cusolverDnCreateParams": [_VP],
    "cusolverDnSetStream": [_VP, _VP],
    # handle, params, uplo, n, dataTypeA, A, lda, computeType, then the
    # device and host workspace sizes (out) or buffers and sizes, and info
    "cusolverDnXpotrf_bufferSize": [_VP, _VP, _INT, _I64, _INT, _VP, _I64,
                                    _INT, _VP, _VP],
    "cusolverDnXpotrf": [_VP, _VP, _INT, _I64, _INT, _VP, _I64, _INT, _VP,
                         ctypes.c_size_t, _VP, ctypes.c_size_t, _VP],
}


class _Solver:
    """cuSOLVER's entry points; per device a handle and its params; per
    (device, n, dtype) the workspace sizes and the host workspace."""

    def __init__(self, device: torch.device):
        lib = ctypes.CDLL(str(_loaded_cusolver(device)))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            setattr(self, name[len("cusolverDn"):], fn)
        self.handles: dict[int, tuple[_VP, _VP]] = {}
        self.work: dict[tuple, tuple[int, int, ctypes.Array | None]] = {}

    def handle(self, index: int) -> tuple[_VP, _VP]:
        if index not in self.handles:
            handle, params = _VP(), _VP()
            with torch.cuda.device(index):
                _check(self.Create(ctypes.byref(handle)), "cusolverDnCreate")
                _check(self.CreateParams(ctypes.byref(params)),
                       "cusolverDnCreateParams")
            self.handles[index] = (handle, params)
        return self.handles[index]

    def workspace(self, index: int, A: Tensor, dtype: int):
        """(device bytes, host bytes, host buffer) for potrf of A."""
        key = (index, A.shape[0], dtype)
        if key not in self.work:
            handle, params = self.handle(index)
            dev_bytes, host_bytes = ctypes.c_size_t(), ctypes.c_size_t()
            _check(self.Xpotrf_bufferSize(
                handle, params, _FILL_LOWER, A.shape[0], dtype, A.data_ptr(),
                A.shape[0], dtype, ctypes.byref(dev_bytes),
                ctypes.byref(host_bytes)), "cusolverDnXpotrf_bufferSize")
            host = host_bytes.value
            self.work[key] = (dev_bytes.value, host,
                              ctypes.create_string_buffer(host) if host
                              else None)
        return self.work[key]


_SOLVER: _Solver | None = None


def _loaded_cusolver(device: torch.device) -> Path:
    """Path of the cuSOLVER library in this process, after a 1 x 1
    factorization has made PyTorch load its CUDA linear algebra."""
    torch.linalg.cholesky_ex(torch.ones((1, 1), device=device))
    with open("/proc/self/maps") as maps:
        for line in maps:
            path = Path(line.split()[-1])
            if path.name.startswith("libcusolver.so"):
                return path
    raise RuntimeError("PyTorch's CUDA linear algebra loaded no cuSOLVER "
                       "library into this process")


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} failed: cusolverStatus {status}")


def _factor_on_card(Ky: Tensor) -> tuple[Tensor, Tensor]:
    global _SOLVER
    if _SOLVER is None:
        _SOLVER = _Solver(Ky.device)
    index = Ky.device.index
    if index is None:
        index = torch.cuda.current_device()
    n, dtype = Ky.shape[0], _DATA_TYPE[Ky.dtype]
    handle, params = _SOLVER.handle(index)
    dev_bytes, host_bytes, host = _SOLVER.workspace(index, Ky, dtype)
    work = torch.empty(max(dev_bytes, 1), dtype=torch.uint8,
                       device=Ky.device)
    info = torch.empty((), dtype=torch.int32, device=Ky.device)
    stream = torch.cuda.current_stream(Ky.device).cuda_stream
    _check(_SOLVER.SetStream(handle, stream), "cusolverDnSetStream")
    _check(_SOLVER.Xpotrf(handle, params, _FILL_LOWER, n, dtype,
                          Ky.data_ptr(), n, dtype, work.data_ptr(),
                          dev_bytes, host, host_bytes, info.data_ptr()),
           "cusolverDnXpotrf")
    count("factor_in_place")
    return Ky.mT, info


def cholesky_in_place(Ky: Tensor) -> tuple[Tensor, Tensor]:
    """(L, info) for a symmetric positive definite Ky, as
    ``torch.linalg.cholesky_ex(Ky)`` gives them: info is 0 on success and
    i > 0 where the leading minor of order i is not positive definite.

    On a non-empty square contiguous CUDA matrix of float32 or float64 the
    factor is written over Ky and L is the view ``Ky.mT``, column-major as
    ``cholesky_ex``'s: its lower triangle holds the factor, its strict
    upper triangle still holds Ky's entries (read neither Ky after the
    call nor L above its diagonal), and info is a device int32 scalar.
    Every other input takes ``torch.linalg.cholesky_ex`` and leaves Ky as
    it was.
    """
    if (Ky.is_cuda and Ky.ndim == 2 and Ky.shape[0] == Ky.shape[1]
            and Ky.numel() > 0 and Ky.is_contiguous()
            and Ky.dtype in _DATA_TYPE):
        return _factor_on_card(Ky)
    return torch.linalg.cholesky_ex(Ky)
