"""PyTorch port vs JAX: the covariance build and its gradient contraction
(``ops/cuda_cov.py`` against ``sympgpr_tpu/ops/pallas_cov.py``).

JAX runs the Pallas kernels in interpret mode on the CPU, as
``tests/test_pallas_cov.py`` and ``tests/test_fast_grad.py`` do; the port
runs the kernels' plain versions (CPU tensors), float64.  Tolerances: the
build at 1e-12 (the same closed forms); the contraction at rtol 1e-9
against JAX and against autograd of the autodiff-free builds (the
hand-written derivatives against reverse mode: sums of 2N x 2N0 terms in
another order).
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import npy, tt  # noqa: E402

from sympgpr_tpu.kernels import variants as jkv  # noqa: E402
from sympgpr_tpu.ops import pallas_cov  # noqa: E402
from sympgpr_tpu_torch.gp import likelihood  # noqa: E402
from sympgpr_tpu_torch.gp.covariance import build_K, build_K_fast  # noqa: E402
from sympgpr_tpu_torch.kernels import variants as kv  # noqa: E402
from sympgpr_tpu_torch.ops import cuda_cov  # noqa: E402

PARAMS = {
    "per_se": [0.9, 1.7],
    "se_se": [1.1, 0.8],
    "per_se_freq": [0.9, 1.7, 0.37],
    "sum_per_se": [0.9, 1.7],
}
NAMES = sorted(PARAMS)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 2 * np.pi, n),
                     rng.uniform(-2.0, 2.0, n)], 1)


def _case(name, n=40, n0=24):
    X, X0 = _points(n, 1), _points(n0, 2)
    Kbar = np.random.default_rng(3).normal(size=(2 * n, 2 * n0))
    return X, X0, np.array(PARAMS[name]), 1.8, Kbar


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n,n0", [(40, 24), (64, 64)])
def test_build_matches_jax(name, n, n0):
    X, X0, params, sig, _ = _case(name, n, n0)
    K_j = pallas_cov.build_K_pallas(
        jkv.get_kernel(name), jnp.asarray(X), jnp.asarray(X0),
        jnp.asarray(params), jnp.asarray(sig))
    K_t = cuda_cov.build_K_blocks(name, tt(X), tt(X0), tt(params), tt(sig))
    assert K_t.shape == (2 * n, 2 * n0)
    np.testing.assert_allclose(npy(K_t), np.asarray(K_j), rtol=0,
                               atol=1e-12 * float(np.max(np.abs(K_j))))


@pytest.mark.parametrize("name", NAMES)
def test_build_matches_autodiff_build_K(name):
    """The tile closed forms against the port's autodiff build_K."""
    X, X0, params, sig, _ = _case(name)
    K_ref = build_K(kv.get_kernel(name), tt(X), tt(X0), tt(params), tt(sig))
    K_t = cuda_cov.build_K_blocks_reference(name, tt(X), tt(X0), tt(params),
                                            tt(sig))
    np.testing.assert_allclose(npy(K_t), npy(K_ref), rtol=0,
                               atol=1e-12 * float(K_ref.abs().max()))


@pytest.mark.parametrize("name", NAMES)
def test_contraction_matches_jax(name):
    X, X0, params, sig, Kbar = _case(name)
    dp_j, ds_j = pallas_cov.cov_param_grads(
        name, jnp.asarray(X), jnp.asarray(X0), jnp.asarray(params),
        jnp.asarray(sig), jnp.asarray(Kbar), tile=256, interpret=True)
    dp_t, ds_t = cuda_cov.cov_param_grads(name, tt(X), tt(X0), tt(params),
                                          tt(sig), tt(Kbar))
    assert dp_t.shape == (len(params),)
    np.testing.assert_allclose(npy(dp_t), np.asarray(dp_j), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(ds_t), float(ds_j), rtol=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_contraction_matches_autograd(name):
    """Hand-written derivatives of all four kinds against reverse mode of
    build_K_fast (build_K for the sum kernel, which has no fast form)."""
    X, X0, params, sig, Kbar = _case(name)
    p = tt(params).requires_grad_(True)
    s = tt(sig).requires_grad_(True)
    build = build_K if name == "sum_per_se" else build_K_fast
    K = build(kv.get_kernel(name), tt(X), tt(X0), p, s)
    dp_ref, ds_ref = torch.autograd.grad(K, (p, s), tt(Kbar))
    dp, ds = cuda_cov.cov_param_grads_reference(name, tt(X), tt(X0),
                                                tt(params), tt(sig), tt(Kbar))
    np.testing.assert_allclose(npy(dp), npy(dp_ref), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(ds), float(ds_ref), rtol=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_buildk_gradcheck(name):
    """BuildK: forward = build, backward = contraction, float64."""
    X, X0, params, sig, _ = _case(name, 6, 5)
    p = tt(params).requires_grad_(True)
    s = tt(sig).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda pp, ss: cuda_cov.BuildK.apply(name, tt(X), tt(X0), pp, ss),
        (p, s))


def test_buildk_zero_data_cotangents():
    X = tt(_points(8, 4)).requires_grad_(True)
    p = tt(PARAMS["per_se"]).requires_grad_(True)
    s = tt(1.3).requires_grad_(True)
    K = cuda_cov.build_K_cuda(kv.PER_SE, X, X, p, s)
    gX, gp, gs = torch.autograd.grad(K.sum(), (X, p, s))
    assert torch.equal(gX, torch.zeros_like(gX))
    assert gp.shape == (2,) and gs.shape == ()


def test_unused_trailing_params_get_zeros():
    X, X0, _, sig, Kbar = _case("per_se")
    params = tt([0.9, 1.7, 5.0])
    dp, _ = cuda_cov.cov_param_grads("per_se", tt(X), tt(X0), params,
                                     tt(sig), tt(Kbar))
    dp2, _ = cuda_cov.cov_param_grads("per_se", tt(X), tt(X0), params[:2],
                                      tt(sig), tt(Kbar))
    assert dp.shape == (3,) and float(dp[2]) == 0.0
    np.testing.assert_array_equal(npy(dp[:2]), npy(dp2))


def test_dispatch(monkeypatch):
    X32 = tt(_points(16, 6), torch.float32)
    assert not cuda_cov.want_cuda_build(kv.PER_SE, X32)
    assert cuda_cov.nll_threshold() == 512
    monkeypatch.setattr(cuda_cov, "NLL_THRESHOLD", 1)
    assert cuda_cov.want_cuda_build(kv.PER_SE, X32)
    assert not cuda_cov.want_cuda_build(kv.PER_SE, X32.double())


def test_nll_dispatches_to_kernel_build(monkeypatch):
    """With the threshold forced down, nll goes through BuildK (its plain
    versions on the CPU) and agrees with the default path; float32, so
    the ill-conditioned solve's 1e-3 relative of test_pallas_cov.py."""
    X = tt(_points(64, 4), torch.float32)
    rng = np.random.default_rng(5)
    z = tt(rng.normal(size=128) * 0.1, torch.float32)
    p = tt([0.9, 1.7], torch.float32)
    sig = tt(2.0, torch.float32)
    s2 = tt(1e-4, torch.float32)
    v_default = likelihood.nll(kv.PER_SE, p, sig, s2, X, z)
    monkeypatch.setattr(cuda_cov, "NLL_THRESHOLD", 1)
    calls = []
    reference = cuda_cov.build_K_blocks_reference

    def counted(*args):
        calls.append(1)
        return reference(*args)

    monkeypatch.setattr(cuda_cov, "build_K_blocks_reference", counted)
    v_kernel = likelihood.nll(kv.PER_SE, p, sig, s2, X, z)
    assert calls
    np.testing.assert_allclose(float(v_kernel), float(v_default), rtol=1e-3)


def test_wrappers_refuse_other_devices():
    X = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_cov.build_K_blocks("per_se", X, X, torch.ones(2), torch.ones(()))
    with pytest.raises(ValueError, match="no covariance kernel"):
        cuda_cov.build_K_blocks("other", tt(_points(4, 0)), tt(_points(4, 0)),
                                tt([1.0, 1.0]), tt(1.0))
