"""PyTorch port vs JAX: the closed-form NLL gradient and the on-device
Adam fit (``gp/likelihood.py::nll_value_and_grad``,
``gp/train.py::fit_sympgp_ondevice``).

Float64 on the CPU: value and gradient against JAX's
``nll_value_and_grad`` and against autograd of the port's ``nll`` at 1e-8
(the tests/test_fast_grad.py tolerance), the 5-step Adam fit against JAX
at rtol 1e-9.  The port forms Ky^{-1} from the blocked triangular inverse
and the syrk on the CPU too (the JAX package takes ``cho_solve`` there).
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import npy, tt  # noqa: E402

from sympgpr_tpu.gp import likelihood as jlik  # noqa: E402
from sympgpr_tpu.gp import train as jtrain  # noqa: E402
from sympgpr_tpu.kernels import variants as jkv  # noqa: E402
from sympgpr_tpu_torch.gp import likelihood  # noqa: E402
from sympgpr_tpu_torch.gp.train import fit_sympgp_ondevice  # noqa: E402
from sympgpr_tpu_torch.kernels import variants as kv  # noqa: E402
from sympgpr_tpu_torch.ops import cuda_cov  # noqa: E402
from sympgpr_tpu_torch.workloads.tokamak_large import (  # noqa: E402
    fit_sympgp_large)

PARAMS = {"per_se": [0.9, 1.7], "per_se_freq": [0.9, 1.7, 0.37]}


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 2 * np.pi, n),
                     rng.uniform(-2.0, 2.0, n)], 1)


def _case(n=48, seed=4):
    X = _points(n, seed)
    z = np.random.default_rng(seed + 1).normal(size=2 * n) * 0.3
    return X, z


@pytest.mark.parametrize("kernel_path", [False, True])
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_nll_value_and_grad(name, kernel_path, monkeypatch):
    """Against JAX and autograd; ``kernel_path`` forces the structure the
    card runs at large N (BuildK forward, hand-written contraction) in
    float64 through the plain versions."""
    if kernel_path:
        monkeypatch.setattr(cuda_cov, "want_cuda_build", lambda k, X: True)
    X, z = _case()
    params, sig, s2 = PARAMS[name], 2.0, 1e-6
    val, dp, ds = likelihood.nll_value_and_grad(
        kv.get_kernel(name), tt(params), tt(sig), tt(s2), tt(X), tt(z))
    v_j, dp_j, ds_j = jlik.nll_value_and_grad(
        jkv.get_kernel(name), jnp.asarray(params), jnp.asarray(sig),
        jnp.asarray(s2), jnp.asarray(X), jnp.asarray(z))
    np.testing.assert_allclose(float(val), float(v_j), rtol=1e-8)
    np.testing.assert_allclose(npy(dp), np.asarray(dp_j), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(float(ds), float(ds_j), rtol=1e-8)

    p = tt(params).requires_grad_(True)
    s = tt(sig).requires_grad_(True)
    ref = likelihood.nll(kv.get_kernel(name), p, s, tt(s2), tt(X), tt(z))
    gp_ref, gs_ref = torch.autograd.grad(ref, (p, s))
    np.testing.assert_allclose(float(val), float(ref), rtol=1e-12)
    np.testing.assert_allclose(npy(dp), npy(gp_ref), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(float(ds), float(gs_ref), rtol=1e-8)


def test_nll_value_and_grad_theta():
    X, z = _case(32, 6)
    theta = [-0.1, 0.2, 0.4]
    val, g = likelihood.nll_value_and_grad_theta(
        kv.PER_SE, tt(theta), tt(1e-6), tt(X), tt(z))
    v_j, g_j = jlik.nll_value_and_grad_theta(
        jkv.PER_SE, jnp.asarray(theta), jnp.asarray(1e-6), jnp.asarray(X),
        jnp.asarray(z))
    # the value of an ill-conditioned (sig2n 1e-6) solve: two Cholesky
    # implementations differ at ~4e-11 relative here
    np.testing.assert_allclose(float(val), float(v_j), rtol=1e-8)
    np.testing.assert_allclose(npy(g), np.asarray(g_j), rtol=1e-8,
                               atol=1e-12)


def test_failed_cholesky_gives_nan():
    """cholesky_ex leaves a finite partial factor; the value and gradient
    must be NaN as in JAX, so that the fit escalates its jitter."""
    X, z = _case(12, 7)
    val, dp, ds = likelihood.nll_value_and_grad(  # sig < 0: K indefinite
        kv.PER_SE, tt([0.9, 1.7]), tt(-2.0), tt(1e-6), tt(X), tt(z))
    assert np.isnan(float(val))
    assert torch.isnan(dp).all() and torch.isnan(ds)


def test_failed_cholesky_gives_nan_kernel_path(monkeypatch):
    """The kernels' fused path (forced, plain versions on the CPU) keeps the
    failed factor and poisons value and gradient with a NaN scalar."""
    monkeypatch.setattr(cuda_cov, "want_cuda_build", lambda k, X: True)
    X, z = _case(12, 7)
    val, dp, ds = likelihood.nll_value_and_grad(
        kv.PER_SE, tt([0.9, 1.7]), tt(-2.0), tt(1e-6), tt(X), tt(z))
    assert np.isnan(float(val))
    assert torch.isnan(dp).all() and torch.isnan(ds)


def test_fit_ondevice_matches_jax():
    X, z = _case(40, 9)
    z = z * 0.1
    model, hist, mse, tim = fit_sympgp_ondevice(
        kv.PER_SE, tt(X), tt(z), sig2n=1e-4, steps=5)
    with jax.enable_x64(True):
        model_j, hist_j, mse_j, tim_j = jtrain.fit_sympgp_ondevice(
            jkv.PER_SE, jnp.asarray(X), jnp.asarray(z), sig2n=1e-4, steps=5)
    np.testing.assert_allclose(hist, np.asarray(hist_j), rtol=1e-9)
    np.testing.assert_allclose(npy(model.params), np.asarray(model_j.params),
                               rtol=1e-9)
    np.testing.assert_allclose(float(model.sig), float(model_j.sig),
                               rtol=1e-9)
    # train_mse is the residual of a solve at sig2n 1e-4: its absolute
    # error follows the ~1e-16 of the solution, so it is held at 1e-8
    np.testing.assert_allclose(mse, mse_j, rtol=1e-8)
    np.testing.assert_allclose(npy(model.alpha), np.asarray(model_j.alpha),
                               rtol=1e-7, atol=1e-9)
    assert model.L.shape == (0, 0)
    assert tim["jitter_escalations"] == tim_j["jitter_escalations"] == 0
    assert set(tim) == {"fit_s", "fit_escalation_s", "sig2n_used",
                        "jitter_escalations"}


def test_fit_ondevice_kernel_path(monkeypatch):
    """The fit through the kernels' fused entries (forced, plain versions
    on the CPU, float64) against the default path: the same history,
    hyperparameters, alpha and train_mse (from Ky alpha - sig2n alpha)."""
    X, z = _case(40, 9)
    z = z * 0.1
    ref = fit_sympgp_ondevice(kv.PER_SE, tt(X), tt(z), sig2n=1e-4, steps=5)
    monkeypatch.setattr(cuda_cov, "want_cuda_build", lambda k, X: True)
    calls = []
    build = cuda_cov.build_Ky_reference
    monkeypatch.setattr(cuda_cov, "build_Ky_reference",
                        lambda *a: calls.append(1) or build(*a))
    got = fit_sympgp_ondevice(kv.PER_SE, tt(X), tt(z), sig2n=1e-4, steps=5)
    assert len(calls) == 6  # five steps and the final solve
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-9)
    for f in ("params", "sig", "alpha"):
        np.testing.assert_allclose(npy(getattr(got[0], f)),
                                   npy(getattr(ref[0], f)), rtol=1e-9)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-6)


def test_jitter_escalation_float32():
    """Port of test_tokamak_large_jitter_escalation: a singular K at
    sig2n 1e-12 in float32 must escalate and end finite."""
    rng = np.random.default_rng(0)
    n = 48
    base = np.stack([rng.uniform(0, 2 * np.pi, n // 2),
                     rng.uniform(0.5, 6.0, n // 2)], 1)
    X = tt(np.concatenate([base, base]), torch.float32)  # singular K
    z = tt(rng.normal(size=2 * n) * 0.1, torch.float32)
    model, hist, mse, tim = fit_sympgp_large(
        X, z, sig2n=1e-12, theta0=(0.5, 2.5, 2.0), steps=5, lr=5e-2)
    assert tim["jitter_escalations"] >= 1
    assert tim["sig2n_used"] > 1e-12
    assert tim["fit_escalation_s"] > 0.0
    assert np.isfinite(hist[-1])
    assert np.isfinite(mse)
    assert model.alpha.dtype == torch.float32
