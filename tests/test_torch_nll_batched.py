"""PyTorch port vs JAX: ``nll_batched`` against ``jax.vmap`` of the NLL's
value and gradient, for the symplectic and the auxiliary GP, one dataset
or a stack, with the NaN pattern of rows whose factorization fails or
whose covariance is not finite.

Each batched row is held against the port's one-row ``nll`` at 1e-10
(the two solve differently: up to 6.3e-11 apart here), and against JAX's
vmapped value at 1e-10 and gradient at 3e-10.  The gradient's floor is not
the batching: at some of these random rows the port's one-row ``nll``
already lies up to 2.1e-10 from JAX's gradient (per_se at lx 1.12, ly 0.89, sig 2.0, N = 12, sig2n
1e-6), from the builds' transcendentals rounding apart by an ulp and the
conditioning of Ky amplifying it.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import npy, t64, toy_data  # noqa: E402

from sympgpr_tpu.gp import likelihood as jlik  # noqa: E402
from sympgpr_tpu.kernels import variants as jvar  # noqa: E402
from sympgpr_tpu_torch.gp import likelihood as tlik  # noqa: E402
from sympgpr_tpu_torch.kernels import variants as tvar  # noqa: E402

RTOL = 1e-10
GRAD_RTOL = 3e-10
SIG2N = 1e-6


def _rows(n_params, B=8, seed=0):
    rng = np.random.default_rng(seed)
    params = rng.uniform(0.6, 1.6, (B, n_params))
    sig = rng.uniform(0.5, 2.0, B)
    return params, sig


def _jax_vg(fn, name, params, sig, X, z, sig2n=SIG2N):
    k = jvar.get_kernel(name)
    x_axis = 0 if np.ndim(X) == 3 else None
    z_axis = 0 if np.ndim(z) == 2 else None

    def one(p, s, x, zz):
        return fn(k, p, s, jnp.asarray(sig2n), x, zz)

    v, (gp, gs) = jax.vmap(jax.value_and_grad(one, argnums=(0, 1)),
                           in_axes=(0, 0, x_axis, z_axis))(
        jnp.asarray(params), jnp.asarray(sig), jnp.asarray(X),
        jnp.asarray(z))
    return np.asarray(v), np.asarray(gp), np.asarray(gs)


def _torch_vg(name, params, sig, X, z, reg=False, sig2n=SIG2N):
    p = t64(params).requires_grad_(True)
    s = t64(sig).requires_grad_(True)
    v = tlik.nll_batched(tvar.get_kernel(name), p, s, sig2n, t64(X), t64(z),
                         reg=reg)
    gp, gs = torch.autograd.grad(v.sum(), (p, s))
    return npy(v), npy(gp), npy(gs)


def _one_row_vg(name, params, sig, X, z, reg=False):
    """The port's one-row NLL, row by row: (values, d params, d sig)."""
    fn = tlik.nll_reg if reg else tlik.nll
    out = []
    for i in range(len(sig)):
        p = t64(params[i]).requires_grad_(True)
        s = t64(sig[i]).requires_grad_(True)
        Xi, zi = (X[i], z[i]) if np.ndim(X) == 3 else (X, z)
        v = fn(tvar.get_kernel(name), p, s, t64(SIG2N), t64(Xi), t64(zi))
        gp, gs = torch.autograd.grad(v, (p, s))
        out.append((float(v.detach()), npy(gp), float(gs)))
    return tuple(np.array(c) for c in zip(*out))


def _check(got, want, one_row):
    for g, w, o, rtol in zip(got, want, one_row,
                             (RTOL, GRAD_RTOL, GRAD_RTOL)):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, o, rtol=RTOL)
        np.testing.assert_allclose(g, w, rtol=rtol)


@pytest.mark.parametrize("name", ["per_se", "se_se", "per_se_freq"])
def test_nll_batched_matches_vmapped_jax(name):
    X, z, _, _ = toy_data(16, seed=1)
    params, sig = _rows(jvar.get_kernel(name).n_params)
    _check(_torch_vg(name, params, sig, X, z),
           _jax_vg(jlik.nll, name, params, sig, X, z),
           _one_row_vg(name, params, sig, X, z))


@pytest.mark.parametrize("name", ["per_se", "se_se"])
def test_nll_reg_batched_matches_vmapped_jax(name):
    _, _, Xp, zp = toy_data(16, seed=2)
    params, sig = _rows(2, seed=3)
    _check(_torch_vg(name, params, sig, Xp, zp, reg=True),
           _jax_vg(jlik.nll_reg, name, params, sig, Xp, zp),
           _one_row_vg(name, params, sig, Xp, zp, reg=True))


@pytest.mark.parametrize("reg", [False, True])
def test_nll_batched_over_stacked_datasets(reg):
    """(B, N, 2) sets with (B, 2N) targets, one per row, as the batched
    Adam fits use them."""
    sets = [toy_data(12, seed=10 + b) for b in range(4)]
    if reg:
        Xs = np.stack([s[2] for s in sets])
        zs = np.stack([s[3] for s in sets])
    else:
        Xs = np.stack([s[0] for s in sets])
        zs = np.stack([s[1] for s in sets])
    params, sig = _rows(2, B=4, seed=5)
    fn = jlik.nll_reg if reg else jlik.nll
    _check(_torch_vg("per_se", params, sig, Xs, zs, reg=reg),
           _jax_vg(fn, "per_se", params, sig, Xs, zs),
           _one_row_vg("per_se", params, sig, Xs, zs, reg=reg))


def test_failed_rows_take_the_fallback_with_jax_nan_pattern():
    """A negative sig makes Ky indefinite (the Cholesky fails: the
    floored-eigh value, equal to the port's ``nll``); lx = 0 makes it not
    finite (NaN).  The gradient's NaN pattern is JAX's vmapped one,
    whatever it is; the healthy rows beside them are unaffected."""
    X, z, _, _ = toy_data(6, seed=4)
    params = np.array([[0.9, 1.2], [0.9, 1.2], [0.0, 1.2], [1.1, 0.8]])
    sig = np.array([1.5, -0.5, 1.0, 0.7])
    vj, gpj, gsj = _jax_vg(jlik.nll, "per_se", params, sig, X, z, 1e-3)
    vt, gpt, gst = _torch_vg("per_se", params, sig, X, z, sig2n=1e-3)
    single = float(tlik.nll(tvar.PER_SE, t64(params[1]), t64(sig[1]),
                            t64(1e-3), t64(X), t64(z)))
    np.testing.assert_allclose(vt[1], single, rtol=RTOL)
    np.testing.assert_array_equal(np.isnan(vt), np.isnan(vj))
    np.testing.assert_allclose(vt[[0, 1, 3]], vj[[0, 1, 3]], rtol=RTOL)
    np.testing.assert_array_equal(np.isnan(gpt), np.isnan(gpj))
    np.testing.assert_array_equal(np.isnan(gst), np.isnan(gsj))
    assert np.isnan(gpj[1]).all() and np.isnan(gpj[2]).all()
    for g, w in ((gpt, gpj), (gst, gsj)):
        np.testing.assert_allclose(g[[0, 3]], w[[0, 3]], rtol=RTOL)


def test_failed_rows_match_per_row_nll_and_eigh_runs_on_them_only(
        monkeypatch):
    """Each row of a batch with failed rows equals the port's one-row
    ``nll``; eigh sees the failed rows alone."""
    X, z, _, _ = toy_data(6, seed=4)
    params = np.array([[0.9, 1.2], [0.8, 1.0], [1.0, 0.9], [1.1, 0.8]])
    sig = np.array([1.5, -0.5, 1.0, -0.7])
    seen = []
    eigh = torch.linalg.eigh

    def spy(A):
        seen.append(A.shape[0])
        return eigh(A)

    monkeypatch.setattr(torch.linalg, "eigh", spy)
    v = tlik.nll_batched(tvar.PER_SE, t64(params), t64(sig), 1e-3, t64(X),
                         t64(z))
    assert seen == [2]
    for i in range(4):
        want = tlik.nll(tvar.PER_SE, t64(params[i]), t64(sig[i]), t64(1e-3),
                        t64(X), t64(z))
        np.testing.assert_allclose(float(v[i]), float(want), rtol=RTOL)
