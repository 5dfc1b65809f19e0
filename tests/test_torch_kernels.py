"""PyTorch port vs JAX: Halton points, kernel derivative sets, covariance
builders.  float64 on both sides; the tolerance is 1e-12 relative, the
one the JAX package's own covariance tests use (only summation order and
the autodiff expression order differ)."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import t64, npy  # noqa: E402

from sympgpr_tpu.gp import covariance as jcov  # noqa: E402
from sympgpr_tpu.kernels import variants as jvar  # noqa: E402
from sympgpr_tpu.ops import pallas_cov  # noqa: E402
from sympgpr_tpu.systems.halton import halton as jhalton  # noqa: E402
from sympgpr_tpu_torch.gp import covariance as tcov  # noqa: E402
from sympgpr_tpu_torch.kernels import variants as tvar  # noqa: E402
from sympgpr_tpu_torch.systems.halton import halton as thalton  # noqa: E402

NAMES = ["per_se", "se_se", "sum_per_se", "per_se_freq"]
RTOL, ATOL = 1e-12, 1e-14


def _params(name, rng):
    k = jvar.get_kernel(name)
    return rng.uniform(0.5, 1.5, k.n_params)


def test_halton_identical():
    for dim in (1, 3, 5):
        np.testing.assert_array_equal(thalton(97, dim), jhalton(97, dim))
    np.testing.assert_array_equal(thalton(10, 2, start=7),
                                  jhalton(10, 2, start=7))


def test_get_kernel_registry():
    assert sorted(tvar.KERNELS) == sorted(jvar.KERNELS)
    for name in NAMES:
        tk, jk = tvar.get_kernel(name), jvar.get_kernel(name)
        assert (tk.n_params, tk.separable) == (jk.n_params, jk.separable)
        assert tk.code == pallas_cov.KINDS[name]  # the kernels' kind
        assert tvar.BY_CODE[tk.code] is tk
        assert tk.product == (name in pallas_cov.PRODUCT_KINDS)
    with pytest.raises(KeyError, match="unknown kernel"):
        tvar.get_kernel("nope")


@pytest.mark.parametrize("name", NAMES)
def test_kernel_derivatives(name):
    rng = np.random.default_rng(3)
    jk, tk = jvar.get_kernel(name), tvar.get_kernel(name)
    for _ in range(4):
        u, v = rng.uniform(-3, 3, 2), rng.uniform(-3, 3, 2)
        p = _params(name, rng)
        ju, jv, jp = jnp.asarray(u), jnp.asarray(v), jnp.asarray(p)
        tu, tv, tp = t64(u), t64(v), t64(p)
        np.testing.assert_allclose(npy(tk.fn(tu, tv, tp)),
                                   npy(jk.fn(ju, jv, jp)), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(npy(tk.grad_u(tu, tv, tp)),
                                   npy(jk.grad_u(ju, jv, jp)), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(npy(tk.hess_uv(tu, tv, tp)),
                                   npy(jk.hess_uv(ju, jv, jp)), rtol=RTOL,
                                   atol=ATOL)


def _points(rng, n, n0):
    X = np.stack([rng.uniform(0, 2 * np.pi, n), rng.uniform(-1, 1, n)], 1)
    X0 = np.stack([rng.uniform(0, 2 * np.pi, n0), rng.uniform(-1, 1, n0)], 1)
    return X, X0


@pytest.mark.parametrize("name", NAMES)
def test_build_K_and_Kreg(name):
    """Rectangular (N != N0) so a transposed layout cannot pass."""
    rng = np.random.default_rng(5)
    X, X0 = _points(rng, 9, 7)
    p = _params(name, rng)
    jk, tk = jvar.get_kernel(name), tvar.get_kernel(name)
    for jf, tf in ((jcov.build_K, tcov.build_K),
                   (jcov.build_Kreg, tcov.build_Kreg),
                   (jcov.build_K_fast, tcov.build_K_fast)):
        Kj = jf(jk, jnp.asarray(X), jnp.asarray(X0), jnp.asarray(p), 1.7)
        Kt = tf(tk, t64(X), t64(X0), t64(p), t64(1.7))
        assert Kt.shape == Kj.shape and Kt.dtype == torch.float64
        np.testing.assert_allclose(npy(Kt), npy(Kj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["per_se", "se_se", "per_se_freq"])
def test_build_K_fast_matches_autodiff_build(name):
    """The closed forms reproduce the autodiff build inside the port."""
    rng = np.random.default_rng(8)
    X, _ = _points(rng, 12, 1)
    p = t64(_params(name, rng))
    k = tvar.get_kernel(name)
    Kf = tcov.build_K_fast(k, t64(X), t64(X), p, t64(0.8))
    Ka = tcov.build_K(k, t64(X), t64(X), p, t64(0.8))
    np.testing.assert_allclose(npy(Kf), npy(Ka), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_row_blocks_match_build_K_fast(name):
    """The distributed build's row blocks are ``build_K_fast``'s blocks
    (sig 1) on the rows they cover, and the autodiff Hessian blocks."""
    from sympgpr_tpu_torch.distributed.large import _row_blocks

    rng = np.random.default_rng(11)
    n, rows = 12, slice(3, 8)
    X = t64(_points(rng, n, 1)[0])
    p = t64(_params(name, rng))
    k = tvar.get_kernel(name)
    K = tcov.build_K_fast(k, X, X, p, t64(1.0))
    H = tcov.hess_blocks(k, X[rows], X, p)
    for got, blk, r, c in zip(_row_blocks(k, X[rows], X, p),
                              (K[:n, :n], K[:n, n:], K[n:, n:]),
                              (0, 0, 1), (0, 1, 1)):
        np.testing.assert_allclose(npy(got), npy(blk[rows]), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(npy(got), npy(H[..., r, c]), rtol=RTOL,
                                   atol=ATOL)
