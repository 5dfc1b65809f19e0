"""PyTorch port vs JAX: NLL value and gradient, the eigh fallback, the
jitter escalation, the objective and the L-BFGS fits.

Value and gradient at fixed hyperparameters are held at 1e-10 relative:
both sides run the same float64 formulas through different Cholesky,
triangular-solve and autodiff code, whose rounding differs at ~1e-13 and
is amplified by the conditioning of Ky.  Fitted hyperparameters are held
looser (see ``test_fits_match_jax``).
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, npy, t64, toy_data  # noqa: E402

from sympgpr_tpu.gp import likelihood as jlik  # noqa: E402
from sympgpr_tpu.gp import train as jtrain  # noqa: E402
from sympgpr_tpu.kernels import variants as jvar  # noqa: E402
from sympgpr_tpu_torch.gp import likelihood as tlik  # noqa: E402
from sympgpr_tpu_torch.gp import train as ttrain  # noqa: E402
from sympgpr_tpu_torch.kernels import variants as tvar  # noqa: E402

RTOL = 1e-10


def _value_grad_jax(fn, name, params, sig, sig2n, X, z):
    k = jvar.get_kernel(name)
    v, (gp, gs) = jax.value_and_grad(
        lambda p, s: fn(k, p, s, jnp.asarray(sig2n), jnp.asarray(X),
                        jnp.asarray(z)), argnums=(0, 1))(
        jnp.asarray(params), jnp.asarray(sig))
    return float(v), np.asarray(gp), float(gs)


def _value_grad_torch(fn, name, params, sig, sig2n, X, z):
    k = tvar.get_kernel(name)
    p = t64(params).requires_grad_(True)
    s = t64(sig).requires_grad_(True)
    v = fn(k, p, s, t64(sig2n), t64(X), t64(z))
    gp, gs = torch.autograd.grad(v, (p, s))
    return float(v.detach()), npy(gp), float(gs)


def _check(fn_j, fn_t, name, params, sig, sig2n, X, z):
    vj, gpj, gsj = _value_grad_jax(fn_j, name, params, sig, sig2n, X, z)
    vt, gpt, gst = _value_grad_torch(fn_t, name, params, sig, sig2n, X, z)
    assert np.isfinite(vt) and np.all(np.isfinite(gpt))
    np.testing.assert_allclose(vt, vj, rtol=RTOL)
    np.testing.assert_allclose(gpt, gpj, rtol=RTOL)
    np.testing.assert_allclose(gst, gsj, rtol=RTOL)


@pytest.mark.parametrize("name", ["per_se", "se_se", "per_se_freq"])
def test_nll_value_and_grad(name):
    X, z, _, _ = toy_data(16, seed=1)
    params = [0.9, 1.2, 0.55][: jvar.get_kernel(name).n_params]
    _check(jlik.nll, tlik.nll, name, params, 1.5, 1e-6, X, z)


@pytest.mark.parametrize("name", ["per_se", "se_se"])
def test_nll_reg_value_and_grad(name):
    _, _, Xp, zp = toy_data(16, seed=2)
    _check(jlik.nll_reg, tlik.nll_reg, name, [0.8, 1.1], 0.7, 1e-6, Xp, zp)


def test_nll_eigh_fallback():
    """A negative signal variance makes Ky indefinite: both packages take
    the floored-eigh branch and agree on the value.  The JAX package's
    gradient there is NaN (the failed Cholesky's VJP poisons the untaken
    branch), so the port's finite gradient is held against JAX's gradient
    of the fallback formula itself."""
    X, z, _, _ = toy_data(6, seed=4)
    k = tvar.get_kernel("per_se")
    from sympgpr_tpu.gp.covariance import build_K_fast as jbuild
    from sympgpr_tpu_torch.gp.covariance import build_K_fast

    params, sig, sig2n = [0.9, 1.2], -0.5, 1e-3
    Ky = build_K_fast(k, t64(X), t64(X), t64(params), t64(sig))
    Ky = Ky + sig2n * torch.eye(12, dtype=torch.float64)
    assert int(torch.linalg.cholesky_ex(Ky).info) != 0  # really indefinite

    def eig_nll(p, s):
        K = jbuild(jvar.PER_SE, jnp.asarray(X), jnp.asarray(X), p, s)
        w, Q = jnp.linalg.eigh(K + sig2n * jnp.eye(12))
        w = jnp.maximum(w, jnp.maximum(jnp.max(jnp.abs(w)) * 1e-14, 1e-300))
        zz = jnp.asarray(z)
        return 0.5 * zz @ (Q @ ((Q.T @ zz) / w)) + 0.5 * jnp.sum(jnp.log(w))

    vj, (gpj, gsj) = jax.value_and_grad(eig_nll, argnums=(0, 1))(
        jnp.asarray(params), jnp.asarray(sig))
    vt, gpt, gst = _value_grad_torch(tlik.nll, "per_se", params, sig, sig2n,
                                     X, z)
    v_pkg, _, _ = _value_grad_jax(jlik.nll, "per_se", params, sig, sig2n,
                                  X, z)
    np.testing.assert_allclose(vt, v_pkg, rtol=RTOL)
    np.testing.assert_allclose(vt, float(vj), rtol=RTOL)
    assert np.all(np.isfinite(gpt)) and np.isfinite(gst)
    np.testing.assert_allclose(gpt, np.asarray(gpj), rtol=RTOL)
    np.testing.assert_allclose(gst, float(gsj), rtol=RTOL)


def test_nll_nonfinite_is_nan_with_nan_grad():
    """lx = 0 makes K non-finite: NaN value and gradient, as in JAX."""
    X, z, _, _ = toy_data(6, seed=4)
    vj, _, _ = _value_grad_jax(jlik.nll, "per_se", [0.0, 1.2], 1.0, 1e-6,
                               X, z)
    vt, gpt, gst = _value_grad_torch(tlik.nll, "per_se", [0.0, 1.2], 1.0,
                                     1e-6, X, z)
    assert np.isnan(vj) and np.isnan(vt)
    assert np.isnan(gst)


def test_chol_and_alpha_jitter_escalation():
    """A rank-deficient Ky escalates jitter the same way in both."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((8, 3))
    Ky = A @ A.T  # rank 3: the first factorization fails
    z = rng.standard_normal(8)
    Lj, aj = jlik.chol_and_alpha(jnp.asarray(Ky), jnp.asarray(z))
    Lt, at = tlik.chol_and_alpha(t64(Ky), t64(z))
    # the factor of a nearly singular matrix is ill-determined in its last
    # columns, so hold what it factors: Ky + jitter I with the same jitter
    jit_j = np.diag(npy(Lj) @ npy(Lj).T - Ky)
    jit_t = np.diag(npy(Lt @ Lt.T) - Ky)
    # jitter ~7e-12, escalated in steps of 100x; the diagonal of L L^T
    # carries ~1e-15 of rounding from its O(1) entries
    assert jit_t.min() > 1e-12
    np.testing.assert_allclose(jit_t, jit_j, rtol=0, atol=1e-14)
    np.testing.assert_allclose(npy(Lt @ Lt.T) - np.diag(jit_t), Ky,
                               atol=1e-12)
    # alpha solves a system of condition ~1e12, so its residual is only
    # ~1e12 * 1e-16 relative
    np.testing.assert_allclose(npy(Lt @ (Lt.T @ at)), z, atol=1e-3)
    with pytest.raises(np.linalg.LinAlgError):
        tlik.chol_and_alpha(t64(-np.eye(3)), t64(np.ones(3)),
                            max_jitter_tries=2)


@pytest.mark.parametrize("transform", ["log10", "linear"])
def test_objective_value_and_grad(transform):
    X, z, _, _ = toy_data(16, seed=6)
    theta = np.array([-0.1, 0.05, 0.3] if transform == "log10"
                     else [0.8, -1.1, 2.0])
    oj = jtrain.make_objective(jlik.nll, jvar.PER_SE, jnp.asarray(X),
                               jnp.asarray(z), 1e-8, transform=transform)
    ot = ttrain.make_objective(tlik.nll, tvar.PER_SE, t64(X), t64(z), 1e-8,
                               transform=transform)
    vj, gj = jax.value_and_grad(oj)(jnp.asarray(theta))
    vt, gt = ttrain.value_and_grad(ot, t64(theta))
    np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL)
    np.testing.assert_allclose(npy(gt), np.asarray(gj), rtol=RTOL)


def test_objective_fixed_sig():
    X, z, _, _ = toy_data(12, seed=7)
    theta = np.array([0.1, -0.2])
    oj = jtrain.make_objective(jlik.nll, jvar.PER_SE, jnp.asarray(X),
                               jnp.asarray(z), 1e-8, fixed_sig=2.0)
    ot = ttrain.make_objective(tlik.nll, tvar.PER_SE, t64(X), t64(z), 1e-8,
                               fixed_sig=2.0)
    np.testing.assert_allclose(float(ot(t64(theta))),
                               float(oj(jnp.asarray(theta))), rtol=RTOL)


@pytest.fixture(scope="module")
def tokamak_data():
    from sympgpr_tpu.systems import tokamak as jtk

    d = jtk.training_data(jtk.TokamakConfig(N=40))
    return {k: d[k][:, 0] for k in ("q", "p", "Q", "P")}


def test_fits_match_jax(tokamak_data):
    """Both fits of the tokamak workload on identical N=40 data.

    The NLL and its gradient agree to ~1e-13, but scipy's L-BFGS-B line
    search is path-sensitive: a last-digit difference in one gradient can
    move the next trial point, so the two runs may stop at slightly
    different points of a flat optimum.  The fitted hyperparameters are
    held at rtol 1e-4 and the NLL at the optimum at rtol 1e-8 (the
    optimum is flat, so the value moves far less than the argument)."""
    d = tokamak_data
    q, p, Q, P = d["q"], d["p"], d["Q"], d["P"]
    from sympgpr_tpu.workloads.tokamak import _fit_one_split as jfit

    from sympgpr_tpu.systems.tokamak import TokamakConfig as JCfg
    from sympgpr_tpu_torch.systems.tokamak import TokamakConfig as TCfg
    from sympgpr_tpu_torch.workloads.tokamak import _fit_one_split as tfit

    aux_j, sgp_j, res_j = jfit(q, p, Q, P, JCfg(N=40), "lbfgs")
    aux_t, sgp_t, res_t = tfit(t64(q), t64(p), t64(Q), t64(P), TCfg(N=40),
                               "lbfgs")
    assert res_t.success
    np.testing.assert_allclose(npy(sgp_t.params), np.asarray(sgp_j.params),
                               rtol=1e-4)
    np.testing.assert_allclose(float(sgp_t.sig), float(sgp_j.sig), rtol=1e-4)
    np.testing.assert_allclose(res_t.fun, res_j.fun, rtol=1e-8)
    np.testing.assert_allclose(npy(aux_t.params), np.asarray(aux_j.params),
                               rtol=1e-4)
    np.testing.assert_allclose(float(aux_t.sig), float(aux_j.sig), rtol=1e-4)
    assert float(sgp_t.training_error()) < 1e-12
    assert sgp_t.X.device == CPU and sgp_t.params.dtype == torch.float64


def test_non_lbfgs_optimizer_raises():
    """CMA-ES (test_torch_split.py) and Adam (test_torch_adam.py) are
    ported; an optimizer name outside ``_MINIMIZERS`` is refused."""
    X, z, _, _ = toy_data(6)
    assert sorted(ttrain._MINIMIZERS) == ["adam", "cmaes", "lbfgs"]
    with pytest.raises(NotImplementedError, match="sgd"):
        ttrain.fit_sympgp(tvar.PER_SE, t64(X), t64(z), sig2n=1e-8,
                          x0=(0.0, 0.0, 0.0), optimizer="sgd")
