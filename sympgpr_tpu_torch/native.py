"""ctypes bindings to the native (C++) data-generation runtime (PyTorch
port of ``sympgpr_tpu/native.py``).

The library is the repository's ``native/fieldlines.cc`` and
``native/henon.cc``, plain C++ with a C ABI (the JAX package's), built
with g++ on first use into ``sympgpr_tpu_torch/_build/`` and loaded
through ctypes.  Its functions take and return numpy arrays on the host.
Everything it computes also has a PyTorch implementation
(``systems/tokamak.py``, ``systems/henon_heiles.py``), so the native
library is an oracle and a host-side data generator, not a dependency of
any path: ``available()`` says whether it builds here, and a failed build
raises ``NativeUnavailable``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
_SOURCES = tuple(_PKG.parent / "native" / f for f in ("fieldlines.cc",
                                                      "henon.cc"))
_LIB = _PKG / "_build" / "libsympgpr_native.so"
# the JAX package's native/Makefile flags, so both libraries compute the
# same bits
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall")


class NativeUnavailable(RuntimeError):
    pass


def build(force: bool = False) -> str:
    """Build the native library (idempotent): g++ over the sources into
    ``_build/``."""
    if force or not _LIB.exists():
        _LIB.parent.mkdir(parents=True, exist_ok=True)
        tmp = _LIB.with_name(f"{_LIB.stem}.{os.getpid()}.tmp.so")
        try:
            subprocess.run(["g++", *CXXFLAGS, "-o", str(tmp),
                            *map(str, _SOURCES)],
                           check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            detail = getattr(e, "stderr", str(e))
            raise NativeUnavailable(f"native build failed: {detail}") from e
        tmp.replace(_LIB)  # atomic: a concurrent loader sees old or new
    return str(_LIB)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    d = ctypes.c_double
    i = ctypes.c_int
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

    lib.sympgpr_ath.restype = d
    lib.sympgpr_ath.argtypes = [d, d]
    lib.sympgpr_compute_r.restype = d
    lib.sympgpr_compute_r.argtypes = [d, d, d]
    lib.sympgpr_fieldlines_integrate.restype = None
    lib.sympgpr_fieldlines_integrate.argtypes = [
        d, i, i, d, i, i, i, pd, pd, pd,
    ]
    lib.sympgpr_henon_sections.restype = None
    lib.sympgpr_henon_sections.argtypes = [
        d, d, d, d, i, i, i, pd, pd, pd, pi,
    ]
    return lib


def available() -> bool:
    try:
        _lib()
        return True
    except NativeUnavailable:
        return False


def fieldlines_integrate(
    eps: float, m: int, n: int, phase: float, nph: int, nsteps: int,
    z0: np.ndarray, r0: np.ndarray,
) -> np.ndarray:
    """Native twin of ``systems.tokamak.integrate_fieldlines``.

    z0: (npart, 3) [pth, th, ph]; r0: (npart,); returns (nsteps+1, npart,
    3).
    """
    z0 = np.ascontiguousarray(z0, np.float64)
    r0 = np.ascontiguousarray(r0, np.float64)
    npart = z0.shape[0]
    if z0.shape != (npart, 3) or r0.shape != (npart,):
        raise ValueError(f"z0 must be (npart, 3) and r0 (npart,); got "
                         f"{z0.shape}, {r0.shape}")
    out = np.empty((nsteps + 1, npart, 3), np.float64)
    _lib().sympgpr_fieldlines_integrate(
        eps, m, n, phase, nph, nsteps, npart, z0, r0, out
    )
    return out


def compute_r(pth: float, th: float, rstart: float = 0.3) -> float:
    return float(_lib().sympgpr_compute_r(pth, th, rstart))


def henon_sections(
    z0: np.ndarray, max_cuts: int, lam: float = 1.0, w1: float = 1.0,
    w2: float = 1.0, dt: float = 0.01, max_steps: int | None = None,
):
    """Native twin of ``systems.henon_heiles.integrate_sections``.

    z0: (npart, 4); returns (cuts (max_cuts, npart, 4), tcuts (max_cuts,
    npart), counts (npart,)).
    """
    z0 = np.ascontiguousarray(z0, np.float64)
    npart = z0.shape[0]
    if z0.shape != (npart, 4):
        raise ValueError(f"z0 must be (npart, 4); got {z0.shape}")
    if max_steps is None:
        max_steps = int((max_cuts + 2) * 7.5 / dt)
    cuts = np.empty((max_cuts, npart, 4), np.float64)
    tcuts = np.empty((max_cuts, npart), np.float64)
    counts = np.empty(npart, np.int32)
    _lib().sympgpr_henon_sections(
        lam, w1, w2, dt, max_steps, max_cuts, npart, z0, cuts, tcuts, counts
    )
    return cuts, tcuts, counts
