"""The port's adaptive HMC against the quadrature truth of the pendulum
hyperposterior: gate 2 of ``tests/test_posterior_parity.py`` through
``sympgpr_tpu_torch/eval/posterior.py`` (4 chains x 600 after 300 warmup
transitions from step 0.02, 16 leapfrog steps where the JAX test runs 24),
on the JAX package's training set."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_parity import CPU, npy, pendulum_posterior_data  # noqa: E402

from sympgpr_tpu_torch.eval import posterior as post  # noqa: E402


def test_adaptive_hmc_matches_quadrature_moments():
    """Dual-averaging HMC from ``find_reasonable_eps``; the un-initialized
    warmup (eps0 anchored at 0.02) wedged all-rejecting in the JAX
    package."""
    X, z = pendulum_posterior_data(post.N_TRAIN)
    problem = post.pendulum_problem(CPU, X, z)
    quad = post.quadrature(problem["logprob"], CPU)
    assert quad["edge_mass"] < 1e-3
    r = post.run_hmc(problem["logprob"], CPU)
    assert float(r.accept_rate.min()) > post.HMC_MIN_ACCEPT
    c = post.moment_check(npy(r.samples).reshape(-1, 3), quad,
                          post.HMC_STD_RTOL)
    assert c["ok"], c
