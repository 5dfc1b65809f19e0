"""The hand-written CUDA kernels of the large-N fit against their plain
PyTorch versions, on the card: covariance build and contraction
(``ops/cuda_cov.py``, with the fit's fused entries ``build_Ky`` and
``cov_param_grads_sym``), triangular matmul (``ops/cuda_trimm.py``), syrk
(``ops/cuda_syrk.py``), the alpha product (``ops/cuda_matvec.py``) and the
fit step's alpha and value from it, the blocked Cholesky written over Ky
(``linalg/potrf.py``) against its plain version and ``cholesky_ex``'s, the
jitter escalation of the fit through them, and a fit step that never makes
the host wait for the card.

Needs a CUDA device and nvcc; skips otherwise.  Needs no JAX:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_linalg.py

Tolerances: float64 at 1e-12 relative to the output's largest value (the
same formulas, another order of summation); float32 at 1e-5 relative to
it for the build (a few ulp of each transcendental) and at 1e-4 for the
contraction and the triangular products (sums of thousands of float32
terms in another order; the plain float32 version carries that much
error itself).  The syrk accumulates float32 in float64, so it is held
against the plain version in float64 at 1e-6 (one float32 rounding).  The
alpha product also sums in float64: its float32 result is held within one
float32 ulp of the float64 product, and both dtypes within 1e-13 of each
row's sum of |S x| terms (two float64 orders of summation).  The
fused contraction on the inverse of a real GP covariance cancels almost
all of its terms, so there it is held within 3x the error of the plain
version on the float32 Kbar, as ``chip_smoke.py`` does.
"""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import npy  # noqa: E402

from sympgpr_tpu_torch.gp.covariance import build_K_fast  # noqa: E402
from sympgpr_tpu_torch.gp.likelihood import (  # noqa: E402
    nll_value_and_grad, nll_value_and_grad_theta)
from sympgpr_tpu_torch.gp import train  # noqa: E402
from sympgpr_tpu_torch.kernels import variants as kv  # noqa: E402
from sympgpr_tpu_torch.linalg import potrf, triangular  # noqa: E402
from sympgpr_tpu_torch.linalg.potrf import cholesky_in_place  # noqa: E402
from sympgpr_tpu_torch.linalg.triangular import (  # noqa: E402
    spd_inverse_from_chol, tri_inv_blocked)
from sympgpr_tpu_torch.ops import (  # noqa: E402
    cuda_cov, cuda_matvec, cuda_syrk, cuda_trimm)
from sympgpr_tpu_torch.profiling import launch_counts  # noqa: E402
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
    before = launch_counts()["cov_fwd"]
    K = cuda_cov.build_K_blocks(name, X, X0, p, s)
    torch.cuda.synchronize()
    assert launch_counts()["cov_fwd"] == before + 1
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
    before = launch_counts()["cov_bwd"]
    dp, ds = cuda_cov.cov_param_grads(name, X, X0, p, s, Kbar)
    torch.cuda.synchronize()
    assert launch_counts()["cov_bwd"] == before + 1
    f64 = [t.double() for t in (X, X0, p, s, Kbar)]
    dp_r, ds_r = cuda_cov.cov_param_grads_reference(name, *f64)
    got = torch.cat([dp.double(), ds.double()[None]])
    ref = torch.cat([dp_r, ds_r[None]])
    assert _rel(got, ref) <= RTOL[dt]


# below, at and across the 64-wide pair tile, off the 16-byte vector
RAGGED = [1, 7, 33, 127, 129, 300, 513, 1000]


@pytest.mark.parametrize("n", RAGGED)
@pytest.mark.parametrize("mode", ["general", "Ky"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_build_modes_ragged(cuda, name, dtype, mode, n):
    """The build kernel against the plain versions, on X0 != X and as
    ``build_Ky`` (X0 = X with a diagonal term).  The diagonal term is
    exact: Ky(jitter) - Ky(0) is jitter on the diagonal and 0 elsewhere."""
    dt = DTYPES[dtype]
    tol = 1e-5 if dt == torch.float32 else 1e-12
    X = _points(n, 1, dt, cuda)
    p = torch.tensor(PARAMS[name], dtype=dt, device=cuda)
    s = torch.tensor(2.5, dtype=dt, device=cuda)
    before = launch_counts()["cov_fwd"]
    if mode == "general":
        X0 = _points(n // 3 + 2, 2, dt, cuda)
        K = cuda_cov.build_K_blocks(name, X, X0, p, s)
        torch.cuda.synchronize()
        assert launch_counts()["cov_fwd"] == before + 1
        assert _rel(K, cuda_cov.build_K_blocks_reference(name, X, X0, p,
                                                         s)) <= tol
        return
    jitter = torch.tensor(0.37, dtype=dt, device=cuda)
    Ky = cuda_cov.build_Ky(name, X, p, s, jitter)
    Ky0 = cuda_cov.build_Ky(name, X, p, s, 0.0)
    torch.cuda.synchronize()
    assert launch_counts()["cov_fwd"] == before + 2
    assert _rel(Ky, cuda_cov.build_Ky_reference(name, X, p, s, jitter)) <= tol
    diag = torch.eye(2 * n, dtype=torch.bool, device=cuda)
    assert torch.equal(Ky[~diag], Ky0[~diag])
    assert torch.equal(Ky.diagonal(), Ky0.diagonal() + jitter)


@pytest.mark.parametrize("n", RAGGED)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_contraction_sym_matches_plain(cuda, name, dtype, n):
    """The fused contraction on a random symmetric S and alpha against its
    plain version in float64."""
    dt = DTYPES[dtype]
    X = _points(n, 1, dt, cuda)
    p = torch.tensor(PARAMS[name], dtype=dt, device=cuda)
    s = torch.tensor(2.5, dtype=dt, device=cuda)
    rng = np.random.default_rng(n)
    A = rng.normal(size=(2 * n, 2 * n))
    S = torch.tensor(A + A.T, dtype=dt, device=cuda)
    alpha = torch.tensor(rng.normal(size=2 * n), dtype=dt, device=cuda)
    before = launch_counts()["cov_bwd"]
    dp, ds = cuda_cov.cov_param_grads_sym(name, X, p, s, S, alpha)
    torch.cuda.synchronize()
    assert launch_counts()["cov_bwd"] == before + 1
    dp_r, ds_r = cuda_cov.cov_param_grads_sym_reference(
        name, *(t.double() for t in (X, p, s, S, alpha)))
    got = torch.cat([dp.double(), ds.double()[None]])
    ref = torch.cat([dp_r, ds_r[None]])
    assert _rel(got, ref) <= RTOL[dt]


def test_contraction_sym_gp_inverse(cuda):
    """The fused contraction on S = W^T W, W = L^{-1} of a float32 GP
    covariance (2N = 2048, the fit's per_se hyperparameters and sig2n),
    and alpha = Ky^{-1} z, against the plain version in float64: within
    3x the plain float32 version's error on the materialised Kbar (L2 over
    the three components), which an all-zero output and a sum over the
    lower tiles without the factor 2 both exceed."""
    X = _points(1024, 7, torch.float32, cuda)
    p = torch.tensor([0.541, 1.391], device=cuda)
    sig = torch.tensor(26.55, device=cuda)
    Ky = cuda_cov.build_Ky("per_se", X, p, sig, 1e-2)
    L, info = torch.linalg.cholesky_ex(Ky)
    assert int(info) == 0
    z = torch.tensor(np.random.default_rng(0).normal(size=2048) * 0.1,
                     dtype=torch.float32, device=cuda)
    alpha = torch.cholesky_solve(z[:, None], L)[:, 0]
    S = spd_inverse_from_chol(L)
    got = torch.cat([t.double().reshape(-1) for t in
                     cuda_cov.cov_param_grads_sym("per_se", X, p, sig, S,
                                                  alpha)])

    def plain(Kbar, dtype):
        dp, ds = cuda_cov.cov_param_grads_reference(
            "per_se", X.to(dtype), X.to(dtype), p.to(dtype), sig.to(dtype),
            Kbar)
        return torch.cat([dp.double(), ds.double()[None]])

    S64, a64 = S.double(), alpha.double()
    Kbar64 = 0.5 * S64 - 0.5 * torch.outer(a64, a64)
    ref = plain(Kbar64, torch.float64)
    bound = 3 * float((plain(0.5 * S - 0.5 * torch.outer(alpha, alpha),
                             torch.float32) - ref).norm())
    tile = torch.arange(1024, device=cuda) // cuda_cov.TILE
    lower = (tile[:, None] >= tile[None, :]).double().repeat(2, 2)
    no_x2 = plain(Kbar64 * lower, torch.float64)
    assert float((got - ref).norm()) <= bound
    assert float(ref.norm()) > bound and float((no_x2 - ref).norm()) > bound


def _view(t, pad):
    """t as a view with row stride s + pad, starting pad elements into a
    NaN-filled buffer; returns the view and the buffer."""
    nb, s, _ = t.shape
    buf = torch.full((nb * s * (s + pad) + pad,), float("nan"),
                     dtype=t.dtype, device=t.device)
    v = buf.as_strided(t.shape, (s * (s + pad), s + pad, 1), pad)
    return v.copy_(t), buf


# s below, at and across the tile (128 float32, 64 float64) and off the
# 16-byte vector (63, 513); "view4" / "view1": operands and output are
# views with row stride s + 4 / s + 1 at element offset 4 / 1 (16-byte
# aligned rows when s % 4 == 0 / never) inside NaN-filled buffers, sign -1
@pytest.mark.parametrize("layout", ["contiguous", "view4", "view1"])
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("s", [1, 63, 100, 128, 200, 300, 513])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("right", [True, False])
def test_trimm_matches_plain(cuda, right, dtype, s, nb, layout):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    A = torch.tensor(rng.standard_normal((nb, s, s)), dtype=dt, device=cuda)
    L = torch.tensor(np.tril(rng.standard_normal((nb, s, s))), dtype=dt,
                     device=cuda)
    poisoned = L + torch.triu(torch.full_like(L, float("nan")), 1)
    ref = (cuda_trimm.matmul_tril_right_reference(A, L) if right
           else cuda_trimm.matmul_tril_left_reference(L, A))
    out, buf, sign = None, None, 1
    if layout != "contiguous":
        pad = 4 if layout == "view4" else 1
        out, buf = _view(torch.zeros_like(A), pad)
        (A, _), (poisoned, _) = _view(A, pad), _view(poisoned, pad)
        sign = -1
    before = launch_counts()["trimm"]
    if right:
        C = cuda_trimm.matmul_tril_right(A, poisoned, out=out, sign=sign)
    else:
        C = cuda_trimm.matmul_tril_left(poisoned, A, out=out, sign=sign)
    torch.cuda.synchronize()
    assert launch_counts()["trimm"] == before + 1
    assert _rel(C, sign * ref) <= RTOL[dt]
    if out is not None:  # written into the view and nowhere else
        assert C is out
        inside = torch.zeros(buf.shape, dtype=torch.bool, device=cuda)
        inside.as_strided(out.shape, out.stride(), pad).fill_(True)
        assert torch.isnan(buf[~inside]).all()


def _syrk_checked(W):
    """The syrk kernel on W with NaN above its diagonal (never read); its
    error against float64 relative to max|S|, S exactly symmetric."""
    before = launch_counts()["syrk"]
    S = cuda_syrk.syrk_lower(W + torch.triu(torch.full_like(W, float("nan")),
                                            1))
    torch.cuda.synchronize()
    assert launch_counts()["syrk"] == before + 1
    assert torch.equal(S, S.T)
    return _rel(S.double(), W.double().T @ W.double())


# n below, at and across the 128-wide tile and the 16-deep k stage, odd n
# (element loads everywhere) and several waves of tile pairs
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [1, 7, 127, 128, 129, 300, 513, 1000, 2048])
def test_syrk_matches_plain(cuda, n, dtype):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(n)
    W = torch.tensor(np.tril(rng.standard_normal((n, n))), dtype=dt,
                     device=cuda)
    assert _syrk_checked(W) <= (1e-6 if dt == torch.float32 else 1e-12)


def test_syrk_gp_inverse_factor(cuda):
    """W = L^{-1} of a float32 GP covariance (2N = 2048, the fit's per_se
    hyperparameters and sig2n) through the kernels, as the fit forms it.
    Dropping the 16 rows of any one k stage changes S by
    max_j sum_k W[k, j]^2 over those rows (the largest entry of a PSD
    matrix is on its diagonal); that is >= 2.5e-2 of max|S| here, so the
    1e-6 tolerance rejects a kernel that drops a k stage."""
    X = _points(1024, 7, torch.float32, cuda)
    p = torch.tensor([0.541, 1.391], device=cuda)
    K = cuda_cov.build_K_blocks("per_se", X, X, p,
                                torch.tensor(26.55, device=cuda))
    L, info = torch.linalg.cholesky_ex(
        K + 1e-2 * torch.eye(K.shape[0], device=cuda))
    assert int(info) == 0
    W = tri_inv_blocked(L).contiguous()
    W64 = W.double()
    scale = float((W64.T @ W64).abs().max())
    sq = (W64 ** 2).reshape(-1, 16, W.shape[0]).sum(1)
    assert float(sq.max(1).values.min()) / scale > 1e3 * 1e-6
    assert _syrk_checked(W) <= 1e-6


def test_spd_inverse_through_kernels(cuda, monkeypatch):
    """Base 96: every combine level (96, 192, 384) is ragged to the trimm
    kernel's 64-wide tile."""
    monkeypatch.setattr(triangular, "BASE", 96)
    rng = np.random.default_rng(0)
    n = 515
    A = rng.standard_normal((n, n))
    Ky = A @ A.T + n * np.eye(n)
    L = torch.tensor(np.linalg.cholesky(Ky), device=cuda)
    before = launch_counts()
    W = tri_inv_blocked(L)
    Kyinv = npy(spd_inverse_from_chol(L))
    after = launch_counts()
    assert after["trimm"] > before["trimm"] and after["syrk"] > before["syrk"]
    assert torch.all(torch.triu(W, 1) == 0)
    np.testing.assert_allclose(Kyinv @ Ky, np.eye(n), atol=1e-9)


def _matvec_case(n, dt, device, offset=0):
    """A random (n, n) S (starting ``offset`` elements into its buffer,
    so off the 16-byte grid for offset 1) and x, on the card."""
    rng = np.random.default_rng(n + offset)
    buf = torch.tensor(rng.standard_normal(n * n + offset), dtype=dt,
                       device=device)
    S = buf[offset:].view(n, n)
    x = torch.tensor(rng.standard_normal(n), dtype=dt, device=device)
    return S, x


# n below, at and off the 16-byte vector (4 float32, 2 float64), across
# the 32-row block and the 32-lane stride, the fit's 8192; offset 1: S off
# the 16-byte grid (element loads)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 33, 300, 1000, 8192])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matvec_matches_plain(cuda, dtype, n, offset):
    dt = DTYPES[dtype]
    S, x = _matvec_case(n, dt, cuda, offset)
    before = launch_counts()["matvec"]
    y = cuda_matvec.matvec(S, x)
    torch.cuda.synchronize()
    assert launch_counts()["matvec"] == before + 1
    assert y.dtype == dt and y.shape == (n,)
    ref = S.double() @ x.double()
    err = (y.double() - ref).abs()
    terms = S.double().abs() @ x.double().abs()
    if dt == torch.float32:  # the float64 sum rounded once
        assert torch.all(err <= ref.abs() * 2.0 ** -23 + 1e-13 * terms)
    else:
        assert torch.all(err <= 1e-13 * terms)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matvec_same_bits_twice(cuda, dtype):
    """Each row is summed in one fixed order: no atomics."""
    S, x = _matvec_case(8192, DTYPES[dtype], cuda)
    before = launch_counts()["matvec"]
    a, b = cuda_matvec.matvec(S, x), cuda_matvec.matvec(S, x)
    torch.cuda.synchronize()
    assert launch_counts()["matvec"] == before + 2
    assert torch.equal(a, b)


def test_matvec_refuses_non_contiguous(cuda):
    S, x = _matvec_case(64, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_matvec.matvec(S.T, x)
    with pytest.raises(ValueError, match="on cpu"):
        cuda_matvec.matvec(S, x.cpu())


def _nll_value_and_grad_by_solve(kernel, params, sig, sig2n, X, z):
    """The fit step's value and gradient with alpha from the two
    triangular solves (``torch.cholesky_solve``), as before the alpha
    product: the autodiff build, Ky^{-1} by ``torch.cholesky_inverse``."""
    params = params.detach().requires_grad_(True)
    sig = sig.detach().requires_grad_(True)
    with torch.enable_grad():
        K = build_K_fast(kernel, X, X, params, sig)
    Ky = K.detach() + torch.abs(sig2n) * torch.eye(K.shape[0],
                                                   dtype=K.dtype,
                                                   device=K.device)
    L = torch.linalg.cholesky(Ky)
    alpha = torch.cholesky_solve(z[:, None], L)[:, 0]
    val = 0.5 * z @ alpha + torch.sum(torch.log(torch.diagonal(L)))
    Kbar = 0.5 * torch.cholesky_inverse(L) - 0.5 * torch.outer(alpha, alpha)
    dparams, dsig = torch.autograd.grad(K, (params, sig), Kbar)
    return val, dparams, dsig


@pytest.mark.parametrize("name", ["per_se", "se_se"])
def test_nll_alpha_from_the_product(cuda, name):
    """float64 on the card: the step takes alpha = S z through the kernel
    (one launch a step) and its value and gradient lie within 1e-10 of
    those with alpha from the two triangular solves (relative to the
    value, and to the gradient's largest component)."""
    kernel = kv.get_kernel(name)
    X = _points(64, 5, torch.float64, cuda)
    z = torch.tensor(np.random.default_rng(6).normal(size=128) * 0.1,
                     dtype=torch.float64, device=cuda)
    params = torch.tensor(PARAMS[name], dtype=torch.float64, device=cuda)
    sig = torch.tensor(2.5, dtype=torch.float64, device=cuda)
    s2n = torch.tensor(1e-2, dtype=torch.float64, device=cuda)
    before = launch_counts()["matvec"]
    got = nll_value_and_grad(kernel, params, sig, s2n, X, z)
    torch.cuda.synchronize()
    assert launch_counts()["matvec"] == before + 1
    ref = _nll_value_and_grad_by_solve(kernel, params, sig, s2n, X, z)
    assert abs(float(got[0] - ref[0])) <= 1e-10 * abs(float(ref[0]))
    g, g_ref = (torch.cat([t[1], t[2][None]]) for t in (got, ref))
    assert float((g - g_ref).abs().max()) <= 1e-10 * float(
        g_ref.abs().max()), (g, g_ref)


def _spd(n, dt, device):
    """A random SPD (n, n) matrix, symmetric to the bit."""
    g = torch.Generator(device=device).manual_seed(n)
    A = torch.randn(n, n, generator=g, dtype=dt, device=device)
    Ky = A @ A.T / n + torch.eye(n, dtype=dt, device=device)
    return 0.5 * (Ky + Ky.T)


@pytest.mark.parametrize("n", [48, 1000, 8192])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_factor_in_place_matches_cholesky_ex(cuda, dtype, n):
    """The factor lands in Ky's own buffer, L = Ky row-major, its lower
    triangle within 1e-6 (float32) or 1e-14 (float64) of ``cholesky_ex``'s
    over the factor's largest entry, its strict upper triangle Ky's entries
    untouched, counted once."""
    dt = DTYPES[dtype]
    Ky = _spd(n, dt, cuda)
    L_ref, info_ref = torch.linalg.cholesky_ex(Ky)
    buf = Ky.clone()
    before = launch_counts()["potrf"]
    L, info = cholesky_in_place(buf)
    torch.cuda.synchronize()
    assert launch_counts()["potrf"] == before + 1
    assert L.data_ptr() == buf.data_ptr() and L.stride() == (n, 1)
    assert int(info) == int(info_ref) == 0
    low = torch.tril(L)
    gap = float((low - L_ref).abs().max() / L_ref.abs().max())
    tol = 1e-6 if dt == torch.float32 else 1e-14
    assert gap <= tol, (f"largest gap {gap:.3e} over max|L|, bits equal: "
                        f"{torch.equal(low, L_ref)}")
    assert torch.equal(torch.triu(L, 1), torch.triu(Ky, 1))


def _backward_error(L, K):
    L = torch.tril(L).double()
    return float(torch.linalg.norm(L @ L.T - K.double())
                 / torch.linalg.norm(K.double()))


# 1001: the last block column 105 wide, rows off the 16-byte vector (the
# element-wise copies of the update)
@pytest.mark.parametrize("n", [48, 1000, 1001, 8192])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_factor_matches_plain(cuda, dtype, n):
    """The kernel against its plain version (the same blocks, float64
    sums in another order) on the card: float32 within 1e-6 of the largest
    entry (a few float32 roundings of the stored blocks apart), float64
    within 1e-14; the backward error ||L L^T - Ky|| / ||Ky|| within 2x of
    the plain version's; the same bits from a second call; garbage above
    the diagonal neither read into L nor overwritten."""
    dt = DTYPES[dtype]
    Ky = _spd(n, dt, cuda)
    up = torch.triu(torch.ones(n, n, dtype=torch.bool, device=cuda), 1)
    dirty = torch.where(up, torch.tensor(float("nan"), dtype=dt,
                                         device=cuda), Ky)
    L, info = cholesky_in_place(dirty.clone())
    L2, info2 = cholesky_in_place(dirty.clone())
    P, info_p = potrf.potrf_lower_reference(Ky.clone())
    assert int(info) == int(info2) == info_p == 0
    assert torch.equal(torch.tril(L), torch.tril(L2))
    assert bool(torch.isnan(L[up]).all())
    low, low_p = torch.tril(L), torch.tril(P)
    gap = float((low - low_p).abs().max() / low_p.abs().max())
    assert gap <= (1e-6 if dt == torch.float32 else 1e-14), gap
    err, err_p = _backward_error(low, Ky), _backward_error(low_p, Ky)
    assert err <= 2 * err_p, (err, err_p)


@pytest.mark.parametrize("where", ["diagonal", "lower", "upper"])
def test_factor_nan_in_ky(cuda, where):
    """NaN on or below Ky's diagonal reports a failing minor at or before
    its row and returns (no hang); NaN above it is never read: info 0 and
    the factor of the clean Ky to the bit."""
    n = 700
    Ky = _spd(n, torch.float32, cuda)
    L_clean, _ = cholesky_in_place(Ky.clone())
    i, j = {"diagonal": (300, 300), "lower": (450, 20),
            "upper": (20, 450)}[where]
    bad = Ky.clone()
    bad[i, j] = float("nan")
    L, info = cholesky_in_place(bad)
    torch.cuda.synchronize()
    if where == "upper":
        assert int(info) == 0
        assert torch.equal(torch.tril(L), torch.tril(L_clean))
    else:
        assert 0 < int(info) <= i + 1, int(info)


def test_factor_in_place_indefinite(cuda, monkeypatch):
    """info > 0 on an indefinite Ky, as ``cholesky_ex`` reports it, and
    NaN in the fit step's value and gradient where its build gives an
    indefinite Ky (a negated covariance), with the factor counted."""
    Ky = torch.eye(64, device=cuda)
    Ky[40, 40] = -1.0
    assert int(cholesky_in_place(Ky.clone())[1]) == 41
    assert int(torch.linalg.cholesky_ex(Ky)[1]) == 41
    monkeypatch.setattr(cuda_cov, "NLL_THRESHOLD", 1)
    build = cuda_cov.build_Ky
    monkeypatch.setattr(cuda_cov, "build_Ky", lambda *a: -build(*a))
    X = _points(32, 4, torch.float32, cuda)
    z = torch.tensor(np.random.default_rng(2).normal(size=64) * 0.1,
                     dtype=torch.float32, device=cuda)
    params = torch.tensor(PARAMS["per_se"], device=cuda)
    before = launch_counts()["potrf"]
    val, dparams, dsig = nll_value_and_grad(
        kv.PER_SE, params, torch.tensor(2.5, device=cuda),
        torch.tensor(1e-2, device=cuda), X, z)
    assert launch_counts()["potrf"] == before + 1
    assert torch.isnan(val) and torch.isnan(dparams).all() \
        and torch.isnan(dsig)


def test_factor_in_place_once_a_step(cuda, monkeypatch):
    """The Adam loop factors Ky in place once a step, and the fit's
    finish (which reads Ky after its factor) does not."""
    monkeypatch.setattr(cuda_cov, "NLL_THRESHOLD", 1)
    X = _points(64, 3, torch.float32, cuda)
    z = torch.tensor(np.random.default_rng(1).normal(size=128) * 0.1,
                     dtype=torch.float32, device=cuda)
    theta0 = torch.log10(torch.tensor([0.9, 1.7, 2.0], device=cuda))
    s2n = torch.tensor(1e-2, device=cuda)
    before = launch_counts()
    theta, hist = train._adam(kv.PER_SE, X, z, theta0, s2n, 7, 5e-2)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["potrf"] == before["potrf"] + 7
    assert after["cov_bwd"] == before["cov_bwd"] + 7
    assert torch.isfinite(hist).all()
    before = after["potrf"]
    tim = fit_sympgp_large(X, z, sig2n=1e-2, theta0=(0.5, 2.5, 2.0),
                           steps=3, lr=5e-2)[3]
    assert launch_counts()["potrf"] == before + 3 * (
        1 + tim["jitter_escalations"])


def test_wrappers_refuse_mixed_devices(cuda):
    X = _points(8, 0, torch.float32, cuda)
    with pytest.raises(ValueError, match="float32"):
        cuda_cov.build_K_blocks("per_se", X, X.cpu(),
                                torch.ones(2, device=cuda),
                                torch.ones((), device=cuda))


def test_fit_step_issues_no_sync(cuda, monkeypatch):
    """One closed-form fit step through the kernels' fused entries makes
    the host wait for the card nowhere (a number copied to the card waited
    for its queue once a step, which left the Adam loop bound by the
    host)."""
    monkeypatch.setattr(cuda_cov, "NLL_THRESHOLD", 1)
    X = _points(64, 3, torch.float32, cuda)
    z = torch.tensor(np.random.default_rng(1).normal(size=128) * 0.1,
                     dtype=torch.float32, device=cuda)
    theta = torch.log10(torch.tensor([0.9, 1.7, 2.0], device=cuda))
    s2n = torch.tensor(1e-2, device=cuda)
    nll_value_and_grad_theta(kv.PER_SE, theta, s2n, X, z)  # loads, handles
    torch.cuda.synchronize()
    before = launch_counts()["cov_bwd"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        val, g = nll_value_and_grad_theta(kv.PER_SE, theta, s2n, X, z)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert launch_counts()["cov_bwd"] == before + 1
    assert torch.isfinite(val) and torch.isfinite(g).all()


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
    before = launch_counts()["cov_bwd"]
    model, hist, mse, tim = fit_sympgp_large(
        X, z, sig2n=1e-12, theta0=(0.5, 2.5, 2.0), steps=5, lr=5e-2)
    assert launch_counts()["cov_bwd"] > before
    assert tim["jitter_escalations"] >= 1 and tim["sig2n_used"] > 1e-12
    assert np.isfinite(hist[-1]) and np.isfinite(mse)
