"""Halton low-discrepancy sequences.

Replaces the reference's external ``ghalton`` dependency
(``ghalton.Halton(dim).get(N)``, e.g. ``python/01_pendulum/main.py:89-90``,
``python/05_tokamak/SympGPR/calc_fieldlines.py:25-26``).  Plain (unscrambled)
Halton over the first ``dim`` primes, starting at index 1 like ghalton, so
training-point distributions match the reference statistically.
"""

from __future__ import annotations

import numpy as np

_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def _radical_inverse(indices: np.ndarray, base: int) -> np.ndarray:
    result = np.zeros(indices.shape, dtype=np.float64)
    f = 1.0 / base
    i = indices.copy()
    while np.any(i > 0):
        result += f * (i % base)
        i //= base
        f /= base
    return result


def halton(n: int, dim: int, start: int = 1) -> np.ndarray:
    """(n, dim) Halton points in [0, 1)^dim."""
    if dim > len(_PRIMES):
        raise ValueError(f"dim <= {len(_PRIMES)} supported")
    idx = np.arange(start, start + n, dtype=np.int64)
    return np.stack(
        [_radical_inverse(idx, _PRIMES[d]) for d in range(dim)], axis=1
    )
