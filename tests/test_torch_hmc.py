"""PyTorch port vs JAX: the HMC transition, ``find_reasonable_eps`` and the
dual-averaging update, given JAX's draws; the port's sampler on the JAX
tests' targets at their gates; the divergent-proposal path.

JAX's threefry streams cannot be reproduced in torch, so a transition is
held given the draws JAX's keys give (``jax.random.split(key)``: the
momenta, then the accept uniform): positions, log-probabilities and
accept probabilities at 1e-10, the accept flags exactly.  On the pendulum
posterior (N = 18, sig2n 1e-8, lengthscales 10-250: Ky is conditioned
near 1e10) the two packages' log-probabilities themselves lie up to
9.4e-9 apart in value and 9.4e-8 in gradient at these start points (the
builds' transcendentals an ulp apart, amplified), so that target is held
at ``PENDULUM_TOL``: positions after 16 steps 6.1e-10 apart, the
log-probabilities 8.3e-9, accept probabilities below 1e-30 only
absolutely.  The sampler runs (own stream) are held at the gates of
``tests/test_predict_hmc.py``.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import npy, pendulum_posterior_data, t64  # noqa: E402

from sympgpr_tpu.gp import hmc as jhmc  # noqa: E402
from sympgpr_tpu.gp import likelihood as jlik  # noqa: E402
from sympgpr_tpu.kernels import PER_SE as J_PER_SE  # noqa: E402
from sympgpr_tpu_torch.gp import hmc  # noqa: E402
from sympgpr_tpu_torch.kernels import PER_SE  # noqa: E402

RTOL = 1e-10
# (rtol of x, rtol of log p, atol of alpha) on the pendulum posterior
PENDULUM_TOL = (1e-8, 1e-7, 1e-12)
SIG2N = 1e-8
PREC = np.array([[1.0, 0.3], [0.3, 0.5]])


def _gaussian():
    pj = jnp.asarray(PREC)
    pt = t64(PREC)
    return (lambda x: -0.5 * x @ pj @ x,
            lambda x: -0.5 * ((x @ pt) * x).sum(-1))


def _half_space():
    """-inf where x0 < 0: a leapfrog step across x0 = 0 is a divergence."""
    return (lambda x: jnp.where(x[0] > 0, -0.5 * x @ x, -jnp.inf),
            lambda x: torch.where(x[:, 0] > 0, -0.5 * (x * x).sum(-1),
                                  -torch.inf))


@pytest.fixture(scope="module")
def pendulum():
    X, z = pendulum_posterior_data()
    return (jax.jit(jhmc.nll_logprob(J_PER_SE, jnp.asarray(X),
                                     jnp.asarray(z), SIG2N, jlik.nll)),
            hmc.nll_logprob(PER_SE, t64(X), t64(z), SIG2N))


def _targets(pendulum):
    return {
        # start points in the posterior's box; step sizes from accepting
        # to rejecting
        "pendulum": (pendulum, [[1.7, 1.2, 2.5], [1.5, 1.0, 1.5],
                                [2.0, 1.4, 3.5], [1.8, 1.1, 2.0]],
                     [0.005, 0.02, 0.05, 0.15]),
        "gaussian": (_gaussian(), [[0.5, -1.0], [1.5, 0.2], [-0.3, 0.8],
                                   [2.0, 2.0]], [0.1, 0.4, 0.9, 1.6]),
        "half_space": (_half_space(), [[0.1, 0.5], [0.3, -0.2],
                                       [0.05, 1.0], [1.0, 0.0]],
                       [0.1, 0.3, 0.5, 0.2]),
    }


def _jax_draws(key, dim):
    kmom, kacc = jax.random.split(key)
    return (np.asarray(jax.random.normal(kmom, (dim,), dtype=jnp.float64)),
            float(jax.random.uniform(kacc, dtype=jnp.float64)))


@pytest.mark.parametrize("target", ["pendulum", "gaussian", "half_space"])
def test_transition_matches_jax_given_its_draws(pendulum, target):
    (jlp, tlp), x0, eps = _targets(pendulum)[target]
    x0 = np.asarray(x0)
    step = jax.jit(jhmc._kernel_one_chain(jlp, 16))
    want, p0s, us = [], [], []
    for c in range(len(x0)):
        key = jax.random.PRNGKey(100 + c)
        p0, u = _jax_draws(key, x0.shape[1])
        p0s.append(p0)
        us.append(u)
        x = jnp.asarray(x0[c])
        (xj, lpj, _), (_, _, accj, alphaj) = step(
            (x, jlp(x), jnp.asarray(eps[c])), key)
        want.append((np.asarray(xj), float(lpj), bool(accj), float(alphaj)))
    x = t64(x0)
    lp, g = hmc.value_and_grad(tlp, x)
    xt, lpt, gt, acct, alphat = hmc.hmc_transition(
        tlp, x, lp, g, t64(eps), t64(np.stack(p0s)), t64(us), 16)
    xj, lpj, accj, alphaj = (np.array(c) for c in zip(*want))
    tx, tlp_, ta = (PENDULUM_TOL if target == "pendulum"
                    else (RTOL, RTOL, 0.0))
    np.testing.assert_array_equal(npy(acct), accj)
    np.testing.assert_allclose(npy(xt), xj, rtol=tx)
    np.testing.assert_allclose(npy(lpt), lpj, rtol=tlp_)
    np.testing.assert_allclose(npy(alphat), alphaj, rtol=RTOL, atol=ta)
    # the carried gradient is the one at the new state
    np.testing.assert_allclose(npy(gt), npy(hmc.value_and_grad(tlp, xt)[1]),
                               rtol=1e-12)
    if target != "gaussian":
        assert accj.any() and not accj.all(), accj  # both branches taken
    if target == "half_space":
        assert np.all(np.isfinite(npy(alphat)))


@pytest.mark.parametrize("target", ["pendulum", "gaussian"])
def test_find_reasonable_eps_equals_jax(pendulum, target):
    """Given JAX's momenta, the same number of doublings or halvings per
    chain: the step sizes are equal."""
    (jlp, tlp), x0, _ = _targets(pendulum)[target]
    x0 = np.asarray(x0)
    eps0 = [1e-3, 0.05, 2.0, 8.0]
    want, r0s = [], []
    for c in range(len(x0)):
        key = jax.random.PRNGKey(7 + c)
        r0s.append(np.asarray(jax.random.normal(key, (x0.shape[1],),
                                                dtype=jnp.float64)))
        x = jnp.asarray(x0[c])
        want.append(float(jax.jit(jhmc.find_reasonable_eps,
                                  static_argnums=0)(
            jlp, x, jlp(x), key, jnp.asarray(eps0[c]))))
    x = t64(x0)
    lp, g = hmc.value_and_grad(tlp, x)
    got = hmc.find_reasonable_eps(tlp, x, lp, g, t64(np.stack(r0s)),
                                  t64(eps0))
    np.testing.assert_array_equal(npy(got), want)
    assert len(set(want)) > 1


def test_dual_averaging_matches_jax_formula():
    """The warmup's update (``sympgpr_tpu/gp/hmc.py`` ``warm_body``) over a
    fixed sequence of accept statistics."""
    rng = np.random.default_rng(0)
    alphas = rng.uniform(0, 1, (50, 3))
    eps0 = np.array([0.01, 0.3, 2.0])
    mu = jnp.log(10.0 * jnp.asarray(eps0))
    gamma, t0c, kappa, target = 0.05, 10.0, 0.75, 0.8
    leb, hb, t = jnp.log(jnp.asarray(eps0)), jnp.zeros(3), jnp.asarray(1.0)
    tleb, thb, tmu = t64(np.log(eps0)), torch.zeros(3, dtype=torch.float64), \
        torch.log(10.0 * t64(eps0))
    for i, a in enumerate(alphas):
        hb = (1 - 1 / (t + t0c)) * hb + ((target - a) / (t + t0c))
        log_eps = mu - jnp.sqrt(t) / gamma * hb
        w = t ** (-kappa)
        leb = w * log_eps + (1 - w) * leb
        t = t + 1.0
        tlog_eps, tleb, thb = hmc.dual_averaging_step(tleb, thb, float(i + 1),
                                                      t64(a), tmu, target)
        np.testing.assert_allclose(npy(tlog_eps), np.asarray(log_eps),
                                   rtol=1e-12)
    np.testing.assert_allclose(npy(tleb), np.asarray(leb), rtol=1e-12)
    np.testing.assert_allclose(npy(thb), np.asarray(hb), rtol=1e-12)


def test_hmc_samples_gaussian():
    """HMC on a known 2-D Gaussian: moments must match."""

    def logprob(x):
        return -0.5 * (x[:, 0] ** 2 / 1.0 + x[:, 1] ** 2 / 4.0)

    x0s = torch.zeros((4, 2), dtype=torch.float64) + t64(
        [[0.1], [-0.1], [0.2], [-0.2]])
    res = hmc.sample_hmc(logprob, x0s, 800, n_warmup=200, step_size=0.4,
                         n_leapfrog=8, seed=0)
    s = npy(res.samples).reshape(-1, 2)
    assert float(res.accept_rate.min()) > 0.5
    np.testing.assert_allclose(s.mean(0), [0, 0], atol=0.15)
    np.testing.assert_allclose(s.var(0), [1.0, 4.0], rtol=0.2)


def _models_data(n=10, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 2 * np.pi, n)
    P = rng.uniform(-1, 1, n)
    X = np.stack([q, P], 1)
    z = np.concatenate([0.2 * np.sin(q), 0.1 * np.cos(q) * P])
    return X, z


def test_hmc_over_gp_hyperparameters():
    X, z = _models_data()
    logprob = hmc.nll_logprob(PER_SE, t64(X), t64(z), 1e-8)
    x0s = torch.zeros((2, 3), dtype=torch.float64) + t64([[0.0], [0.2]])
    res = hmc.sample_hmc(logprob, x0s, 50, n_warmup=50, step_size=0.02,
                         n_leapfrog=8, seed=1)
    assert np.isfinite(npy(res.log_probs)).all()
    assert float(res.accept_rate.min()) > 0.2


def test_hmc_step_size_adaptation():
    """Dual-averaging warmup reaches ~target acceptance on a Gaussian."""

    def logprob(x):
        return -0.5 * torch.sum(x**2, -1)

    x0s = torch.zeros((4, 3), dtype=torch.float64) + 0.1
    res = hmc.sample_hmc(logprob, x0s, 800, n_warmup=400, step_size=1e-3,
                         n_leapfrog=8, seed=2, adapt_step_size=True)
    acc = npy(res.accept_rate)
    assert np.all(acc > 0.55) and np.all(acc < 0.99)
    s = npy(res.samples).reshape(-1, 3)
    np.testing.assert_allclose(s.var(0), np.ones(3), rtol=0.4)


@pytest.mark.parametrize("kind", ["minus_inf", "nan_value_and_grad"])
def test_divergent_proposals_reject_and_adaptation_stays_finite(kind,
                                                                monkeypatch):
    """A log-probability that is -inf on half the space (or NaN there, in
    value and gradient): every proposal across the boundary is rejected,
    the chains stay inside, and the dual-averaging state stays finite."""

    def logprob(x):
        inside = -0.5 * (x * x).sum(-1)
        if kind == "minus_inf":
            return torch.where(x[:, 0] > 0, inside, -torch.inf)
        return inside + 0.0 * torch.sqrt(x[:, 0])

    seen = []
    step = hmc.dual_averaging_step

    def spy(*a):
        out = step(*a)
        seen.append(torch.stack(out))
        return out

    monkeypatch.setattr(hmc, "dual_averaging_step", spy)
    x0s = t64([[0.05, 0.0], [0.2, 0.5], [1.0, -1.0], [0.5, 0.5]])
    res = hmc.sample_hmc(logprob, x0s, 300, n_warmup=200, step_size=0.5,
                         n_leapfrog=8, seed=3, adapt_step_size=True)
    s = npy(res.samples)
    assert np.all(np.isfinite(s)) and np.all(s[..., 0] > 0)
    assert np.all(np.isfinite(npy(res.log_probs)))
    assert len(seen) == 200 and all(torch.isfinite(v).all() for v in seen)
    assert np.all(npy(res.accept_rate) > 0.3)
    assert np.all(np.abs(np.diff(s[:, :, 1], axis=1)).max(1) > 0.1)  # moved
