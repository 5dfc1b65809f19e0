"""The hand-written CUDA kernels of the large-N fit against their plain
PyTorch versions, on the card: covariance build and contraction
(``ops/cuda_cov.py``), triangular matmul (``ops/cuda_trimm.py``), syrk
(``ops/cuda_syrk.py``), and the jitter escalation of the fit through them.

Needs a CUDA device and nvcc; skips otherwise.  Needs no JAX:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_linalg.py

Tolerances: float64 at 1e-12 relative to the output's largest value (the
same formulas, another order of summation); float32 at 1e-5 relative to
it for the build (a few ulp of each transcendental) and at 1e-4 for the
contraction and the triangular products (sums of thousands of float32
terms in another order; the plain float32 version carries that much
error itself).  The syrk accumulates float32 in float64, so it is held
against the plain version in float64 at 1e-6 (one float32 rounding).
"""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import npy  # noqa: E402

from sympgpr_tpu_torch.kernels import variants as kv  # noqa: E402
from sympgpr_tpu_torch.linalg import triangular  # noqa: E402
from sympgpr_tpu_torch.linalg.triangular import (  # noqa: E402
    spd_inverse_from_chol, tri_inv_blocked)
from sympgpr_tpu_torch.ops import cuda_cov, cuda_syrk, cuda_trimm  # noqa: E402
from sympgpr_tpu_torch.workloads.tokamak_large import (  # noqa: E402
    fit_sympgp_large)

pytestmark = pytest.mark.cuda

PARAMS = {"per_se": [0.9, 1.7], "se_se": [1.1, 0.8],
          "per_se_freq": [0.9, 1.7, 0.37], "sum_per_se": [0.9, 1.7]}
DTYPES = {"float32": torch.float32, "float64": torch.float64}
RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _points(n, seed, dtype, device):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(0, 2 * np.pi, n), rng.uniform(-2, 2, n)], 1)
    return torch.tensor(X, dtype=dtype, device=device)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_build_matches_plain(cuda, name, dtype):
    dt = DTYPES[dtype]
    X, X0 = _points(300, 1, dt, cuda), _points(130, 2, dt, cuda)  # ragged
    p = torch.tensor(PARAMS[name], dtype=dt, device=cuda)
    s = torch.tensor(2.5, dtype=dt, device=cuda)
    before = cuda_cov.LAUNCHES_FWD
    K = cuda_cov.build_K_blocks(name, X, X0, p, s)
    torch.cuda.synchronize()
    assert cuda_cov.LAUNCHES_FWD == before + 1
    ref = cuda_cov.build_K_blocks_reference(name, X, X0, p, s)
    assert _rel(K, ref) <= (1e-5 if dt == torch.float32 else 1e-12)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_contraction_matches_plain(cuda, name, dtype):
    dt = DTYPES[dtype]
    X, X0 = _points(300, 1, dt, cuda), _points(130, 2, dt, cuda)
    p = torch.tensor(PARAMS[name], dtype=dt, device=cuda)
    s = torch.tensor(2.5, dtype=dt, device=cuda)
    Kbar = torch.tensor(np.random.default_rng(3).normal(size=(600, 260)),
                        dtype=dt, device=cuda)
    before = cuda_cov.LAUNCHES_BWD
    dp, ds = cuda_cov.cov_param_grads(name, X, X0, p, s, Kbar)
    torch.cuda.synchronize()
    assert cuda_cov.LAUNCHES_BWD == before + 1
    f64 = [t.double() for t in (X, X0, p, s, Kbar)]
    dp_r, ds_r = cuda_cov.cov_param_grads_reference(name, *f64)
    got = torch.cat([dp.double(), ds.double()[None]])
    ref = torch.cat([dp_r, ds_r[None]])
    assert _rel(got, ref) <= RTOL[dt]


@pytest.mark.parametrize("s", [192, 200])  # 200: a ragged edge
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("right", [True, False])
def test_trimm_matches_plain(cuda, right, dtype, s):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    A = torch.tensor(rng.standard_normal((3, s, s)), dtype=dt, device=cuda)
    L = torch.tensor(np.tril(rng.standard_normal((3, s, s))), dtype=dt,
                     device=cuda)
    poisoned = L + torch.triu(torch.full_like(L, float("nan")), 1)
    before = cuda_trimm.LAUNCHES
    if right:
        C = cuda_trimm.matmul_tril_right(A, poisoned)
        ref = cuda_trimm.matmul_tril_right_reference(A, L)
    else:
        C = cuda_trimm.matmul_tril_left(poisoned, A)
        ref = cuda_trimm.matmul_tril_left_reference(L, A)
    torch.cuda.synchronize()
    assert cuda_trimm.LAUNCHES == before + 1
    assert _rel(C, ref) <= RTOL[dt]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [256, 300])
def test_syrk_matches_plain(cuda, n, dtype):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(n)
    W = torch.tensor(np.tril(rng.standard_normal((n, n))), dtype=dt,
                     device=cuda)
    before = cuda_syrk.LAUNCHES
    S = cuda_syrk.syrk_lower(W + torch.triu(torch.full_like(W, float("nan")),
                                            1))
    torch.cuda.synchronize()
    assert cuda_syrk.LAUNCHES == before + 1
    ref = cuda_syrk.syrk_lower_reference(W.double())
    assert _rel(S.double(), ref) <= (1e-6 if dt == torch.float32 else 1e-12)
    assert torch.equal(S, S.T)


def test_spd_inverse_through_kernels(cuda, monkeypatch):
    """Base 96: every combine level (96, 192, 384) is ragged to the trimm
    kernel's 64-wide tile."""
    monkeypatch.setattr(triangular, "BASE", 96)
    rng = np.random.default_rng(0)
    n = 515
    A = rng.standard_normal((n, n))
    Ky = A @ A.T + n * np.eye(n)
    L = torch.tensor(np.linalg.cholesky(Ky), device=cuda)
    before = (cuda_trimm.LAUNCHES, cuda_syrk.LAUNCHES)
    W = tri_inv_blocked(L)
    Kyinv = npy(spd_inverse_from_chol(L))
    assert cuda_trimm.LAUNCHES > before[0] and cuda_syrk.LAUNCHES > before[1]
    assert torch.all(torch.triu(W, 1) == 0)
    np.testing.assert_allclose(Kyinv @ Ky, np.eye(n), atol=1e-9)


def test_wrappers_refuse_mixed_devices(cuda):
    X = _points(8, 0, torch.float32, cuda)
    with pytest.raises(ValueError, match="float32"):
        cuda_cov.build_K_blocks("per_se", X, X.cpu(),
                                torch.ones(2, device=cuda),
                                torch.ones((), device=cuda))


def test_jitter_escalation_on_card(cuda, monkeypatch):
    """The singular-K escalation case through the kernels (threshold
    forced down so N = 48 takes the kernel build)."""
    monkeypatch.setattr(cuda_cov, "NLL_THRESHOLD", 1)
    rng = np.random.default_rng(0)
    n = 48
    base = np.stack([rng.uniform(0, 2 * np.pi, n // 2),
                     rng.uniform(0.5, 6.0, n // 2)], 1)
    X = torch.tensor(np.concatenate([base, base]), dtype=torch.float32,
                     device=cuda)
    z = torch.tensor(rng.normal(size=2 * n) * 0.1, dtype=torch.float32,
                     device=cuda)
    before = cuda_cov.LAUNCHES_BWD
    model, hist, mse, tim = fit_sympgp_large(
        X, z, sig2n=1e-12, theta0=(0.5, 2.5, 2.0), steps=5, lr=5e-2)
    assert cuda_cov.LAUNCHES_BWD > before
    assert tim["jitter_escalations"] >= 1 and tim["sig2n_used"] > 1e-12
    assert np.isfinite(hist[-1]) and np.isfinite(mse)
