"""PyTorch port vs JAX: ``minimize_adam``, ``fit_batch_adam`` and
``fit_sympgp(optimizer="adam")`` (optax's Adam in the JAX package, the
port's one ``adam_update``), on the objectives of ``tests/test_train.py``
and on the N=80 tokamak training set.

Adam's steps are normalized by the gradient's running scale, so the two
packages' ~1e-13 gradient rounding moves the fitted theta by far less than
the 1e-8 held here.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, npy, t64  # noqa: E402

from sympgpr_tpu.gp import likelihood as jlik  # noqa: E402
from sympgpr_tpu.gp import train as jtrain  # noqa: E402
from sympgpr_tpu.kernels import PER_SE as J_PER_SE  # noqa: E402
from sympgpr_tpu_torch.gp import likelihood as tlik  # noqa: E402
from sympgpr_tpu_torch.gp import train as ttrain  # noqa: E402
from sympgpr_tpu_torch.kernels import PER_SE  # noqa: E402

RTOL = 1e-8


def test_minimize_adam_matches_jax():
    """The objective of test_train.py::test_lbfgs_and_adam_agree_on_gp_fit:
    the auxiliary GP's NLL at a fixed sig over log10 lengthscales."""
    rng = np.random.default_rng(0)
    n = 10
    q = rng.uniform(0, 2 * np.pi, n)
    p = rng.uniform(-1, 1, n)
    X = np.stack([q, p], 1)
    z = 0.5 * np.sin(q) + 0.2 * p
    kw = dict(transform="log10", fixed_sig=1.0)
    oj = jtrain.make_objective(jlik.nll_reg, J_PER_SE, jnp.asarray(X),
                               jnp.asarray(z), 1e-6, **kw)
    ot = ttrain.make_objective(tlik.nll_reg, PER_SE, t64(X), t64(z), 1e-6,
                               **kw)
    rj = jtrain.minimize_adam(oj, [0.0, 0.0], lr=3e-2, steps=400)
    rt = ttrain.minimize_adam(ot, [0.0, 0.0], lr=3e-2, steps=400,
                              device=CPU)
    np.testing.assert_allclose(rt.theta, np.asarray(rj.theta), rtol=RTOL)
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=RTOL)
    assert rt.success and rt.nfev == 400


def _three_sets():
    """The datasets of test_train.py::test_fit_batch_adam."""
    rng = np.random.default_rng(2)
    M, n = 3, 8
    Xs, zs = [], []
    for _ in range(M):
        q = rng.uniform(0, 2 * np.pi, n)
        P = rng.uniform(-1, 1, n)
        Xs.append(np.stack([q, P], 1))
        zs.append(np.concatenate([0.2 * np.sin(q), 0.1 * np.cos(q) * P]))
    return np.stack(Xs), np.stack(zs)


@pytest.fixture(scope="module")
def batch_fits():
    Xs, zs = _three_sets()
    kw = dict(sig2n=1e-6, x0=(0.0, 0.0, 0.0), steps=200)
    thj, nllj = jtrain.fit_batch_adam(J_PER_SE, Xs, zs, **kw)
    tht, nllt = ttrain.fit_batch_adam(PER_SE, t64(Xs), t64(zs), **kw)
    return Xs, zs, (np.asarray(thj), np.asarray(nllj)), (npy(tht), npy(nllt))


def test_fit_batch_adam_matches_jax(batch_fits):
    _, _, (thj, nllj), (tht, nllt) = batch_fits
    assert tht.shape == (3, 3) and np.isfinite(nllt).all()
    np.testing.assert_allclose(tht, thj, rtol=RTOL)
    np.testing.assert_allclose(nllt, nllj, rtol=RTOL)


def test_fit_batch_adam_rows_match_minimize_adam(batch_fits):
    """Each row of the batched fit is the one-set fit of its dataset."""
    Xs, zs, _, (tht, nllt) = batch_fits
    for m in range(len(Xs)):
        obj = ttrain.make_objective(tlik.nll, PER_SE, t64(Xs[m]), t64(zs[m]),
                                    1e-6, transform="log10")
        r = ttrain.minimize_adam(obj, [0.0, 0.0, 0.0], steps=200, device=CPU)
        np.testing.assert_allclose(tht[m], r.theta, rtol=1e-10)
        np.testing.assert_allclose(nllt[m], r.fun, rtol=1e-10)


def test_fit_batch_adam_aux_gp():
    """``reg=True``: the auxiliary GP's NLL, as JAX's ``nll_fn=nll_reg``."""
    Xs, zs = _three_sets()
    zr = zs[:, :Xs.shape[1]]
    kw = dict(sig2n=1e-6, x0=(0.0, 0.0, 0.0), steps=50)
    thj, nllj = jtrain.fit_batch_adam(J_PER_SE, Xs, zr, nll_fn=jlik.nll_reg,
                                      **kw)
    tht, nllt = ttrain.fit_batch_adam(PER_SE, t64(Xs), t64(zr), reg=True,
                                      **kw)
    np.testing.assert_allclose(npy(tht), np.asarray(thj), rtol=RTOL)
    np.testing.assert_allclose(npy(nllt), np.asarray(nllj), rtol=RTOL)


def test_fit_sympgp_adam_on_the_tokamak_set():
    """fit_sympgp(optimizer="adam") with the tokamak workload's settings
    (linear transform from (0.5, 0.5, 10), sig2n 1e-14) on its N=80
    training crossings, 300 steps of lr 3e-2."""
    from sympgpr_tpu.systems import tokamak as jtk

    data = jtk.training_data(jtk.TokamakConfig())
    q, p = np.asarray(data["q"][:, 0]), np.asarray(data["p"][:, 0])
    Q, P = np.asarray(data["Q"][:, 0]), np.asarray(data["P"][:, 0])
    X = np.stack([q, P], 1)
    z = np.concatenate([p - P, Q - q])
    kw = dict(sig2n=1e-14, x0=(0.5, 0.5, 10.0), transform="linear",
              optimizer="adam")
    sj, rj = jtrain.fit_sympgp(J_PER_SE, jnp.asarray(X), jnp.asarray(z), **kw)
    st, rt = ttrain.fit_sympgp(PER_SE, t64(X), t64(z), **kw)
    np.testing.assert_allclose(rt.theta, np.asarray(rj.theta), rtol=RTOL)
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=RTOL)
    np.testing.assert_allclose(npy(st.params), np.asarray(sj.params),
                               rtol=RTOL)
    assert st.X.device == CPU and st.params.dtype == torch.float64
