"""PyTorch port vs JAX: the NUTS checkpoint bookkeeping against the
recursion, one lock-step NUTS transition given the draws JAX's keys give,
and the port's sampler on the JAX tests' targets at their gates.

A transition's draws come from JAX's keys as ``sympgpr_tpu/gp/nuts.py``
makes them: ``split(key, 3)`` into the momenta, the doubling directions
(Rademacher) and the tree key, whose ``fold_in(ktree, L + n)`` gives the
uniform of global leaf L + n and ``fold_in(ktree, -1 - depth)`` that of a
doubling.  The proposal, its log-probability and the accept statistic are
held at 1e-10, depth and divergence exactly; on the pendulum posterior
(conditioned near 1e10, see ``tests/test_torch_hmc.py``) at
``PENDULUM_TOL``: the accept statistic, a mean of exp(dH) over up to 64
leaves whose log-probabilities carry the two packages' 1e-8 disagreement,
lies 3.0e-6 apart there.
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
from sympgpr_tpu.gp import nuts as jnuts  # noqa: E402
from sympgpr_tpu.kernels import PER_SE as J_PER_SE  # noqa: E402
from sympgpr_tpu_torch.gp import hmc, nuts  # noqa: E402
from sympgpr_tpu_torch.kernels import PER_SE  # noqa: E402

RTOL = 1e-10
PENDULUM_TOL = (1e-8, 1e-7, 1e-5)  # rtol of x, log p, accept statistic
SIG2N = 1e-8
MAX_DEPTH = 6


def _recursive_check_pairs(lo, hi):
    """All (left, right) leaf pairs the Hoffman-Gelman recursion U-turn
    checks inside a subtree spanning leaves [lo, hi] (size a power of 2)."""
    if hi == lo:
        return []
    mid = (lo + hi) // 2
    return (_recursive_check_pairs(lo, mid)
            + _recursive_check_pairs(mid + 1, hi)
            + [(lo, hi)])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_ckpt_bookkeeping_matches_recursion(as_tensor):
    """The slot/range formulas, on Python ints and on int tensors, give
    exactly the check pairs of the recursive tree, in a valid order, and
    the JAX package's slots."""
    for depth in range(1, 7):
        L = 2 ** depth
        expected = sorted(_recursive_check_pairs(1, L))
        slots, got = {}, []
        for n in range(1, L + 1):
            na = torch.tensor(n) if as_tensor else n
            nj = jnp.asarray(n, jnp.int32)
            if n % 2 == 1:
                slot = int(nuts._store_slot(na))
                assert slot == int(jnuts._store_slot(nj))
                slots[slot] = n
            else:
                lo, hi = (int(v) for v in nuts._check_range(na))
                assert (lo, hi) == tuple(int(v)
                                         for v in jnuts._check_range(nj))
                for k in range(lo, hi + 1):
                    assert k in slots, (depth, n, k, slots)
                    got.append((slots[k], n))
        assert sorted(got) == expected, depth


def _gaussian():
    prec = np.array([[1.0, 0.6], [0.6, 0.8]])
    pj, pt = jnp.asarray(prec), t64(prec)
    return (lambda x: -0.5 * x @ pj @ x,
            lambda x: -0.5 * ((x @ pt) * x).sum(-1))


def _half_space():
    return (lambda x: jnp.where(x[0] > 0, -0.5 * x @ x, -jnp.inf),
            lambda x: torch.where(x[:, 0] > 0, -0.5 * (x * x).sum(-1),
                                  -torch.inf))


@pytest.fixture(scope="module")
def pendulum():
    X, z = pendulum_posterior_data()
    return (jax.jit(jhmc.nll_logprob(J_PER_SE, jnp.asarray(X),
                                     jnp.asarray(z), SIG2N, jlik.nll)),
            hmc.nll_logprob(PER_SE, t64(X), t64(z), SIG2N))


def _jax_draws(key, dim, max_depth):
    kmom, kdir, ktree = jax.random.split(key, 3)
    r0 = jax.random.normal(kmom, (dim,), dtype=jnp.float64)
    dirs = jax.random.rademacher(kdir, (max_depth,), dtype=jnp.int32)

    def u(i):
        return jax.random.uniform(jax.random.fold_in(ktree, i),
                                  dtype=jnp.float64)

    u_leaf = jax.vmap(u)(jnp.arange(2 ** (max_depth + 1), dtype=jnp.int32))
    u_doub = jax.vmap(u)(-1 - jnp.arange(max_depth, dtype=jnp.int32))
    return [np.asarray(a, np.float64) for a in (r0, dirs, u_leaf, u_doub)]


# start points and step sizes: chains that stop at different depths, by a
# U-turn, a divergence or max_depth
CASES = {
    "pendulum": ([[1.7, 1.2, 2.5], [1.5, 1.0, 1.5], [2.0, 1.4, 3.5],
                  [1.8, 1.1, 2.0]], [0.002, 0.01, 0.04, 0.1]),
    "gaussian": ([[0.5, -1.0], [1.5, 0.2], [-0.3, 0.8], [2.0, 2.0]],
                 [0.02, 0.2, 0.7, 1.9]),
    "half_space": ([[0.1, 0.5], [0.3, -0.2], [0.05, 1.0], [1.0, 0.0]],
                   [0.05, 0.3, 0.6, 0.15]),
}


@pytest.mark.parametrize("target", list(CASES))
def test_transition_matches_jax_given_its_draws(pendulum, target):
    jlp, tlp = {"pendulum": pendulum, "gaussian": _gaussian(),
                "half_space": _half_space()}[target]
    x0, eps = CASES[target]
    x0 = np.asarray(x0)
    C, dim = x0.shape
    step = jax.jit(jnuts._kernel_one_chain(jlp, MAX_DEPTH))
    want, draws = [], []
    for c in range(C):
        key = jax.random.PRNGKey(20 + c)
        draws.append(_jax_draws(key, dim, MAX_DEPTH))
        x = jnp.asarray(x0[c])
        _, (xj, lpj, aj, dj, divj) = step((x, jlp(x), jnp.asarray(eps[c])),
                                          key)
        want.append((np.asarray(xj), float(lpj), float(aj), float(dj),
                     bool(divj)))
    d = nuts.NUTSDraws(*(t64(np.stack(a)) for a in zip(*draws)))
    x = t64(x0)
    lp, g = hmc.value_and_grad(tlp, x)
    xt, lpt, gt, at, dt, divt = nuts.nuts_transition(tlp, x, lp, g, t64(eps),
                                                     d, MAX_DEPTH)
    xj, lpj, aj, dj, divj = (np.array(c) for c in zip(*want))
    tx, tl, ta = PENDULUM_TOL if target == "pendulum" else (RTOL,) * 3
    np.testing.assert_array_equal(npy(dt), dj)
    np.testing.assert_array_equal(npy(divt), divj)
    np.testing.assert_allclose(npy(xt), xj, rtol=tx)
    np.testing.assert_allclose(npy(lpt), lpj, rtol=tl)
    np.testing.assert_allclose(npy(at), aj, rtol=ta, atol=1e-300)
    np.testing.assert_allclose(npy(gt), npy(hmc.value_and_grad(tlp, xt)[1]),
                               rtol=1e-12)
    # the lock-step masks are exercised: the chains stop at different
    # depths
    assert len(set(dj.tolist())) > 1, dj
    if target == "half_space":
        assert divj.any() and np.all(np.isfinite(npy(at)))


def test_nuts_samples_gaussian():
    """NUTS on a known anisotropic 2-D Gaussian: moments must match."""

    def logprob(x):
        return -0.5 * (x[:, 0] ** 2 / 1.0 + x[:, 1] ** 2 / 4.0)

    x0s = torch.zeros((4, 2), dtype=torch.float64) + t64(
        [[0.1], [-0.1], [0.2], [-0.2]])
    res = nuts.sample_nuts(logprob, x0s, 800, n_warmup=300, step_size=0.2,
                           max_depth=6, seed=0)
    s = npy(res.samples).reshape(-1, 2)
    assert float(res.accept_stat.min()) > 0.5
    assert int(res.n_divergent.sum()) == 0
    assert float(res.mean_depth.mean()) > 1.0
    np.testing.assert_allclose(s.mean(0), [0, 0], atol=0.15)
    np.testing.assert_allclose(s.var(0), [1.0, 4.0], rtol=0.2)


def test_nuts_correlated_gaussian():
    rho = 0.9
    prec = t64(np.linalg.inv(np.array([[1.0, rho], [rho, 1.0]])))

    def logprob(x):
        return -0.5 * ((x @ prec) * x).sum(-1)

    x0s = t64(np.random.default_rng(1).normal(size=(6, 2)) * 0.1)
    res = nuts.sample_nuts(logprob, x0s, 1200, n_warmup=400, step_size=0.2,
                           max_depth=8, seed=1)
    s = npy(res.samples).reshape(-1, 2)
    np.testing.assert_allclose(np.cov(s.T), [[1.0, rho], [rho, 1.0]],
                               atol=0.15)


def test_nuts_over_gp_hyperparameters():
    rng = np.random.default_rng(0)
    n = 10
    q = rng.uniform(0, 2 * np.pi, n)
    P = rng.uniform(-1, 1, n)
    X = t64(np.stack([q, P], 1))
    z = t64(np.concatenate([0.2 * np.sin(q), 0.1 * np.cos(q) * P]))
    logprob = hmc.nll_logprob(PER_SE, X, z, 1e-8)
    x0s = torch.zeros((2, 3), dtype=torch.float64) + t64([[0.0], [0.2]])
    res = nuts.sample_nuts(logprob, x0s, 60, n_warmup=60, step_size=0.02,
                           max_depth=6, seed=1)
    assert np.isfinite(npy(res.log_probs)).all()
    assert float(res.accept_stat.min()) > 0.2
    res_h = hmc.sample_hmc(logprob, x0s, 200, n_warmup=200, step_size=0.02,
                           n_leapfrog=16, seed=2, adapt_step_size=True)
    m_n = npy(res.samples).reshape(-1, 3).mean(0)
    m_h = npy(res_h.samples).reshape(-1, 3).mean(0)
    np.testing.assert_allclose(m_n[:2], m_h[:2], atol=0.6)


def test_divergent_proposals_keep_the_warmup_finite(monkeypatch):
    """-inf on half the space: divergent trajectories are counted, never
    taken, and the dual-averaging state stays finite."""
    _, logprob = _half_space()
    seen = []
    step = hmc.dual_averaging_step

    def spy(*a):
        out = step(*a)
        seen.append(torch.stack(out))
        return out

    monkeypatch.setattr(hmc, "dual_averaging_step", spy)
    x0s = t64([[0.05, 0.0], [0.2, 0.5], [1.0, -1.0], [0.5, 0.5]])
    res = nuts.sample_nuts(logprob, x0s, 200, n_warmup=100, step_size=0.5,
                           max_depth=6, seed=3)
    s = npy(res.samples)
    assert np.all(np.isfinite(s)) and np.all(s[..., 0] > 0)
    assert len(seen) == 100 and all(torch.isfinite(v).all() for v in seen)
    assert np.all(np.isfinite(npy(res.accept_stat)))
    assert int(res.n_divergent.sum()) > 0
