"""The plain version of the fit step's blocked Cholesky
(``linalg/potrf.py::potrf_lower_reference``), the kernel's algorithm in
its block order, against ``torch.linalg.cholesky_ex`` on the CPU.

Tolerances, relative to the factor's largest entry: float64 at 1e-12 (the
same factor summed in another order); float32 against the float64 factor
of the same matrix at 1e-6 (its sums are float64, so it carries the
roundings of its stored blocks, a few float32 ulps).  The block width is
forced down so that many block columns run, and a ragged last one.
"""

import numpy as np
import pytest
import torch

from sympgpr_tpu_torch.linalg import potrf


def _spd(n, seed, dtype):
    """A random SPD matrix, symmetric to the bit, with eigenvalues in
    [1, 5]."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    K = B @ B.T / n + np.eye(n)
    return torch.tensor(0.5 * (K + K.T), dtype=dtype)


def _gp_cov(n, seed, dtype, sig2n=1e-3):
    """A squared-exponential covariance of n random points in [0, 10]
    with sig2n on its diagonal: condition number ~1e4-1e5."""
    x = np.sort(np.random.default_rng(seed).uniform(0, 10, n))
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) + sig2n * np.eye(n)
    return torch.tensor(K, dtype=dtype)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("n", [1, 7, 127, 128, 129, 300, 1000])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_factor_matches_cholesky_ex(dtype, n, block):
    """The blocked factor, written over A's lower triangle, against
    ``cholesky_ex``'s factor of the float64 matrix; info 0."""
    dt = getattr(torch, dtype)
    K = _spd(n, n, dt)
    L, info = potrf.potrf_lower_reference(K.clone(), block=block)
    ref, info_ref = torch.linalg.cholesky_ex(K.double())
    assert info == int(info_ref) == 0
    tol = 1e-6 if dt == torch.float32 else 1e-12
    assert L.dtype == dt
    assert _rel(torch.tril(L).double(), ref) <= tol


@pytest.mark.parametrize("bad", [0, 15, 16, 40, 127, 128, 200, 299])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_factor_info_is_first_failing_minor(dtype, bad):
    """An indefinite Ky (one diagonal entry negated, at and around block
    boundaries) reports the order of its first failing leading minor, as
    ``cholesky_ex`` does, though the factor goes on past it."""
    dt = getattr(torch, dtype)
    K = _spd(300, 3, dt)
    K[bad, bad] = -1.0
    info_ref = int(torch.linalg.cholesky_ex(K)[1])
    assert info_ref == bad + 1
    assert potrf.potrf_lower_reference(K.clone(), block=16)[1] == info_ref
    assert potrf.potrf_lower_reference(K.clone())[1] == info_ref


@pytest.mark.parametrize("fill", [1e30, float("nan")])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_factor_ignores_upper_triangle(dtype, fill):
    """With 1e30 or NaN above the diagonal the lower triangle is the same
    to the bit and the upper triangle is left as it was."""
    dt = getattr(torch, dtype)
    K = _spd(200, 5, dt)
    up = torch.triu(torch.ones(200, 200, dtype=torch.bool), 1)
    dirty = torch.where(up, torch.tensor(fill, dtype=dt), K)
    L, info = potrf.potrf_lower_reference(K.clone(), block=16)
    Ld, info_d = potrf.potrf_lower_reference(dirty.clone(), block=16)
    assert info == info_d == 0
    assert torch.equal(torch.tril(Ld), torch.tril(L))
    assert torch.equal(Ld[up], dirty[up]) if fill == 1e30 \
        else bool(torch.isnan(Ld[up]).all())


def _backward_error(L, K):
    L = torch.tril(L).double()
    return float(torch.linalg.norm(L @ L.T - K.double())
                 / torch.linalg.norm(K.double()))


@pytest.mark.parametrize("n", [300, 1000])
def test_plain_factor_float64_sums(n):
    """On a float32 GP covariance the float64 sums give a backward error
    ||L L^T - K|| / ||K|| over 3x below the same blocks summed in float32
    (a factor that drops the float64 sum fails), at the kernel's block
    width: with narrow blocks the roundings of the stored blocks, one a
    block column, set the error either way."""
    K = _gp_cov(n, n, torch.float32)
    L64, info = potrf.potrf_lower_reference(K.clone())
    L32, info32 = potrf.potrf_lower_reference(K.clone(), acc=torch.float32)
    assert info == info32 == 0
    e64, e32 = _backward_error(L64, K), _backward_error(L32, K)
    assert 3 * e64 < e32, (e64, e32)
