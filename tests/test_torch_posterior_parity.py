"""The port's samplers against the quadrature truth of the pendulum
hyperposterior: the four gates of ``tests/test_posterior_parity.py``
through ``sympgpr_tpu_torch/eval/posterior.py``, on the JAX package's
training set.

The port's log-probability is first held against JAX's at 512 grid
points.  That posterior is conditioned near 1e10 (N = 18, sig2n 1e-8,
lengthscales 10-250), so the two packages' values lie up to 4.0e-7 apart
there relative (median 7.5e-10; absolute 2.2e-5 on values near 200): an
ulp of difference between their builds' transcendentals, amplified.  They
are held at ``LOGPROB_RTOL``; the quadrature weights move by ~2e-5
relative at most.  The adaptive-HMC gate is in
``tests/test_torch_posterior_hmc.py`` (a file of its own, so the two
samplers run on different test workers).
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_parity import CPU, npy, pendulum_posterior_data, t64  # noqa: E402

from sympgpr_tpu.gp import hmc as jhmc  # noqa: E402
from sympgpr_tpu.gp import likelihood as jlik  # noqa: E402
from sympgpr_tpu.kernels import PER_SE as J_PER_SE  # noqa: E402
from sympgpr_tpu_torch.eval import posterior as post  # noqa: E402

LOGPROB_RTOL = 1e-6


@pytest.fixture(scope="module")
def problem():
    X, z = pendulum_posterior_data(post.N_TRAIN)
    return post.pendulum_problem(CPU, X, z)


@pytest.fixture(scope="module")
def quad(problem):
    q = post.quadrature(problem["logprob"], CPU)
    assert q["edge_mass"] < 1e-3, "posterior mass leaks out of the box"
    return q


@pytest.fixture(scope="module")
def nuts_samples(problem):
    r = post.run_nuts(problem["logprob"], CPU)
    assert float(r.accept_stat.min()) > post.NUTS_MIN_ACCEPT
    return npy(r.samples).reshape(-1, 3)


def test_logprob_matches_jax_on_the_grid(problem):
    X, z = pendulum_posterior_data(post.N_TRAIN)
    jlp = jax.jit(jax.vmap(jhmc.nll_logprob(
        J_PER_SE, jnp.asarray(X), jnp.asarray(z), post.SIG2N, jlik.nll)))
    G = post.grid()
    pts = G[np.random.default_rng(0).choice(len(G), 512, replace=False)]
    want = np.asarray(jlp(jnp.asarray(pts)))
    got = npy(problem["logprob"](t64(pts)))
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=LOGPROB_RTOL)


def test_nuts_matches_quadrature_moments(nuts_samples, quad):
    r = post.moment_check(nuts_samples, quad, post.NUTS_STD_RTOL)
    assert r["ok"], r


def test_marginalized_predictive_bands_agree(problem, nuts_samples, quad):
    r = post.bands_check(problem, nuts_samples, quad)
    assert r["ok"], r


def test_variance_calibration_coverage(problem):
    r = post.coverage_check(problem)
    assert r["ok"], r
