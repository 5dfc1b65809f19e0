"""PyTorch port vs JAX: the generic autodiff map path
(``maps/symplectic.py``, ``prefer_fast=False``) and the posterior
predictions (``gp/predict.py``), on the CPU in float64.

float64 models built by the JAX package at jitter 1e-4 (|alpha| ~ 10) and
carried over through the shared artifact keys, so both sides use the same
alpha.  Every value is held at 1e-12 relative and absolute: against JAX's
generic path (the same derivatives by another autodiff) and against the
port's fast path (the same formulas factorized by hand).  Observed gaps are
in each test's docstring.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import jax_models_to_port, npy, t64, toy_data  # noqa: E402

from sympgpr_tpu.gp import predict as jpr  # noqa: E402
from sympgpr_tpu.gp.model import AuxGP, SympGP  # noqa: E402
from sympgpr_tpu.kernels import variants as jvar  # noqa: E402
from sympgpr_tpu.maps import symplectic as jsm  # noqa: E402
from sympgpr_tpu_torch.gp import predict as tpr  # noqa: E402
from sympgpr_tpu_torch.gp.model import SympGP as TSympGP  # noqa: E402
from sympgpr_tpu_torch.maps import fast_apply as tfa  # noqa: E402
from sympgpr_tpu_torch.maps import symplectic as tsm  # noqa: E402

RTOL, ATOL = 1e-12, 1e-12
KERNELS = ["per_se", "se_se", "per_se_freq", "sum_per_se"]
PRODUCT = ["per_se", "se_se", "per_se_freq"]


def models(name="per_se", seed=0, n=16):
    X, z, Xp, zp = toy_data(n, seed)
    k = jvar.get_kernel(name)
    params = jnp.asarray([0.9, 1.2, 0.55][: k.n_params])
    sgp = SympGP.create(k, params, 1.5, 1e-4, jnp.asarray(X), jnp.asarray(z))
    aux = AuxGP.create(jvar.PER_SE, jnp.asarray([0.9, 1.2]), 1.5, 1e-4,
                       jnp.asarray(Xp), jnp.asarray(zp), delta=True)
    return (sgp, aux), jax_models_to_port(sgp, aux)


def batch(seed=1, b=12):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 2 * np.pi, b), rng.uniform(-0.5, 0.5, b)


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(npy(t), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", KERNELS)
def test_step_pieces_match_jax_and_fast(name):
    """dF_mean, the Newton residual and its slope (a third derivative of
    the kernel), calc_Q and calc_P_explicit against JAX, and pGP, its
    slope and the q update against the port's fast path.  Largest
    absolute gap observed: 4e-14 (se_se) to 6e-13 (sum_per_se)."""
    (js, ja), (ts, ta) = models(name)
    q, p = batch()
    P = p + 0.01
    qj, pj, Pj = map(jnp.asarray, (q, p, P))
    qt, pt, Pt = map(t64, (q, p, P))
    for i in range(3):
        v = np.array([q[i], P[i]])
        close(tsm.dF_mean(ts, t64(v)), jsm.dF_mean(js, jnp.asarray(v)))
        close(tsm.genfun_mean(ts, t64(v)), jsm.genfun_mean(js,
                                                          jnp.asarray(v)))
        for a, b in zip(tsm.p_residual_and_slope(ts, qt[i], Pt[i], pt[i]),
                        jsm.p_residual_and_slope(js, qj[i], Pj[i], pj[i])):
            close(a, b)
        close(tsm.guess_P(ta, qt[i], pt[i]), jsm.guess_P(ja, qj[i], pj[i]))
    close(tsm.calc_Q(ts, qt, Pt), jsm.calc_Q(js, qj, Pj))
    close(tsm.calc_P_explicit(ts, qt, pt), jsm.calc_P_explicit(js, qj, pj))
    if name == "sum_per_se":
        close(tsm.calc_P_explicit(ts, qt, pt),
              pt - tfa.p_explicit_sum(ts, qt))
        close(tsm.calc_Q(ts, qt, Pt), tfa.q_update_sum(ts, Pt))
        return
    co = tfa.precompute_step(ts, qt)
    pGP, slope = tfa.p_value_slope(co, Pt)
    f, fp = torch.func.vmap(
        lambda a, b: tsm.p_residual_and_slope(ts, a, b, torch.zeros(())))(
            qt, Pt)
    close(f - Pt, pGP)
    close(fp - 1.0, slope)
    close(tsm.calc_Q(ts, qt, Pt), tfa.q_update(co, Pt))


@pytest.mark.parametrize("name", KERNELS)
def test_calc_P_matches_jax_and_fast(name):
    """The masked lock-step Newton from the aux guess, with one lane NaN
    from the start (it stays NaN and frozen): against JAX's calc_P and the
    fast path's masked Newton.  Largest absolute gap observed: 2e-14
    (se_se) to 9e-14 (sum_per_se)."""
    (js, ja), (ts, ta) = models(name, seed=2)
    q, p = batch(2)
    q[4] = np.nan
    Pj = jsm.calc_P(js, ja, jnp.asarray(q), jnp.asarray(p), tol=1e-13,
                    maxiter=20)
    Pt = tsm.calc_P(ts, ta, t64(q), t64(p), tol=1e-13, maxiter=20)
    close(Pt, Pj)
    assert np.isnan(npy(Pt)[4]) and np.isfinite(np.delete(npy(Pt), 4)).all()
    if name != "sum_per_se":
        co = tfa.precompute_step(ts, t64(q))
        Pf = tfa.newton_P(co, t64(p), tfa.aux_guess(ta, t64(q), t64(p)),
                          1e-13, 20, fixed_iters=False)
        close(Pt, Pf)
    # the residual vanishes at the solution
    f, _ = torch.func.vmap(
        lambda a, b, c: tsm.p_residual_and_slope(ts, a, b, c))(
            t64(q), Pt, t64(p))
    assert np.nanmax(np.abs(npy(f))) < 1e-12


def test_calc_P_freezes_non_finite_updates():
    """A lane whose Newton update is not finite keeps its last P and is
    done; the others converge as before (mirrors test_maps.py).  Largest
    absolute gap observed: 1e-14."""
    (js, ja), (ts, ta) = models(seed=3)
    q, p = np.array([0.5, 1.5, 3.0]), np.array([0.1, -0.2, np.inf])
    Pt = tsm.calc_P(ts, ta, t64(q), t64(p))
    Pj = jsm.calc_P(js, ja, jnp.asarray(q), jnp.asarray(p))
    np.testing.assert_array_equal(np.isfinite(npy(Pt)),
                                  np.isfinite(np.asarray(Pj)))
    close(Pt[:2], Pj[:2])


def _loss_t(q_old, q_new, P, i):
    return (P > 0.25) & (i >= 2)


def _loss_j(q_old, q_new, P, i):
    return (P > 0.25) & (i >= 2)


@pytest.mark.parametrize("name", PRODUCT)
def test_apply_map_generic_matches_jax_and_fast(name):
    """Six map steps with the loss mask at the old q (some orbits lost
    from step 2 on), with mod_q for the periodic kernels and without it
    for SE x SE: ``apply_map(prefer_fast=False)`` against JAX's generic
    path and against ``prefer_fast=True``.  Largest absolute gap observed:
    6e-14 (se_se) to 1.4e-13 (per_se)."""
    (js, ja), (ts, ta) = models(name, seed=4)
    q, p = batch(4)
    mod_q = None if name == "se_se" else 2 * np.pi
    kw = dict(mod_q=mod_q, newton_tol=1e-12, newton_maxiter=20)
    ref = jsm.apply_map(js, ja, jnp.asarray(q), jnp.asarray(p), 6,
                        jsm.MapConfig(**kw), loss_pre=_loss_j,
                        prefer_fast=False)
    got = tsm.apply_map(ts, ta, t64(q), t64(p), 6, tsm.MapConfig(**kw),
                        loss_pre=_loss_t, prefer_fast=False)
    fast = tsm.apply_map(ts, ta, t64(q), t64(p), 6, tsm.MapConfig(**kw),
                         loss_pre=_loss_t)
    lost = np.isnan(npy(got.p[-1]))
    assert 0 < lost.sum() < 12 and got.pdiff is None
    for a, b, c in zip(got[:2], ref[:2], fast[:2]):
        np.testing.assert_array_equal(npy(torch.isnan(a)),
                                      np.isnan(np.asarray(b)))
        close(a, b)
        close(a, npy(c))


def test_generic_path_does_not_take_the_fast_path(monkeypatch):
    """``prefer_fast=False`` reaches neither the fast step nor its
    rollout."""
    (_, _), (ts, ta) = models()
    q, p = batch(5, 3)

    def refuse(*a, **k):
        raise AssertionError("the fast path ran")

    monkeypatch.setattr(tfa, "map_step", refuse)
    monkeypatch.setattr(tfa, "apply_map_split_fast", refuse)
    traj = tsm.apply_map(ts, ta, t64(q), t64(p), 3, prefer_fast=False)
    assert traj.q.shape == (3, 3)
    traj = tsm.apply_map_split([ts], [ta], t64(q), t64(p), 3, 1,
                               prefer_fast=False)
    assert traj.q.shape == (3, 3)
    with pytest.raises(AssertionError, match="fast path"):
        tsm.apply_map(ts, ta, t64(q), t64(p), 3)


def test_generic_pdiff_matches_jax_and_fast():
    """mod_p with pdiff tracking (the standard map's mode): Q, the wrapped
    P and the unwrapped pdiff.  Largest absolute gap observed: 2.4e-13."""
    (js, ja), (ts, ta) = models(seed=6)
    q, p = batch(6)
    kw = dict(mod_p=2 * np.pi, track_pdiff=True, newton_tol=1e-12,
              newton_maxiter=30)
    ref = jsm.apply_map(js, ja, jnp.asarray(q), jnp.asarray(p), 5,
                        jsm.MapConfig(**kw), prefer_fast=False)
    got = tsm.apply_map(ts, ta, t64(q), t64(p), 5, tsm.MapConfig(**kw),
                        prefer_fast=False)
    fast = tsm.apply_map(ts, ta, t64(q), t64(p), 5, tsm.MapConfig(**kw))
    for a, b, c in zip(got, ref, fast):
        close(a, b)
        close(a, npy(c))
    P = npy(got.p[1:])
    assert P.min() >= 0 and P.max() < 2 * np.pi


@pytest.mark.parametrize("name", ["per_se", "sum_per_se"])
def test_generic_explicit_matches_jax_and_fast(name):
    """The explicit update (Algorithm 2 for the sum kernel, without an aux
    model).  Largest absolute gap observed: 1.3e-13 (per_se), 1.3e-12
    (sum_per_se, whose alpha is ~30x the product kernel's; within 1e-12 of
    the values, up to 2 pi)."""
    (js, _), (ts, _) = models(name, seed=7)
    q, p = batch(7)
    kw = dict(explicit=True, mod_p=2 * np.pi, track_pdiff=True)
    ref = jsm.apply_map(js, None, jnp.asarray(q), jnp.asarray(p), 4,
                        jsm.MapConfig(**kw), prefer_fast=False)
    got = tsm.apply_map(ts, None, t64(q), t64(p), 4, tsm.MapConfig(**kw),
                        prefer_fast=False)
    fast = tsm.apply_map(ts, None, t64(q), t64(p), 4, tsm.MapConfig(**kw))
    for a, b, c in zip(got, ref, fast):
        close(a, b)
        close(a, npy(c))


def test_apply_map_split_generic_matches_jax_and_fast():
    """Two sub-maps cycled with a loss check at the new q: the port's
    ``apply_map_split(prefer_fast=False)`` against JAX's (always generic)
    and against the port's fast Split path.  Largest absolute gap observed:
    1.8e-12, on angles up to 2 pi (3e-13 relative)."""
    (j1, a1), (t1, u1) = models(seed=8)
    (j2, a2), (t2, u2) = models("per_se", seed=9)
    q, p = batch(8)

    def loss_t(q_old, q_new, P, i):
        return P > 0.3

    def loss_j(q_old, q_new, P, i):
        return P > 0.3

    cfg = dict(newton_tol=1e-12, newton_maxiter=20)
    ref = jsm.apply_map_split(jsm.stack_models([j1, j2]),
                              jsm.stack_models([a1, a2]), jnp.asarray(q),
                              jnp.asarray(p), nm=5, n_maps=2,
                              cfg=jsm.MapConfig(**cfg), loss_post=loss_j)
    got = tsm.apply_map_split([t1, t2], [u1, u2], t64(q), t64(p), nm=5,
                              n_maps=2, cfg=tsm.MapConfig(**cfg),
                              loss_post=loss_t, prefer_fast=False)
    fast = tsm.apply_map_split([t1, t2], [u1, u2], t64(q), t64(p), nm=5,
                               n_maps=2, cfg=tsm.MapConfig(**cfg),
                               loss_post=loss_t)
    assert 0 < np.isnan(npy(got.p[-1])).sum() < 12
    for a, b, c in zip(got[:2], ref[:2], fast[:2]):
        close(a, b)
        close(a, npy(c))


@pytest.mark.parametrize("name", KERNELS)
def test_predict_df_matches_jax_and_dF_mean(name):
    """Posterior mean and variance of (dF/dq, dF/dP) at 7 points (three
    of them training points): the means against JAX and against
    ``dF_mean`` (the reference's Kstar.T @ alpha contraction), the
    variances against JAX.  Largest absolute gap observed: 2e-14 (se_se)
    to 7e-13 (sum_per_se)."""
    (js, _), (ts, _) = models(name, seed=10)
    rng = np.random.default_rng(11)
    V = np.concatenate([np.asarray(js.X[:3]),
                        np.stack([rng.uniform(0, 2 * np.pi, 4),
                                  rng.uniform(-1, 1, 4)], 1)])
    mj, vj = jpr.predict_df(js, jnp.asarray(V))
    mt, vt = tpr.predict_df(ts, t64(V))
    assert mt.shape == (7, 2) and vt.shape == (7, 2)
    close(mt, mj)
    close(vt, vj)
    assert (npy(vt) >= 0).all()
    for i in range(7):
        close(mt[i], npy(tsm.dF_mean(ts, t64(V[i]))))
    m_only, none = tpr.predict_df(ts, t64(V), with_var=False)
    assert none is None
    close(m_only, mj)
    # one point: the JAX function's (2N, 2) columns
    Ks = tpr._kstar_deriv(ts, t64(V[3:4]))
    close(Ks, jpr._kstar_deriv(js, jnp.asarray(V[3])))


def test_predict_aux_matches_jax():
    """The aux GP's posterior mean and variance.  Largest absolute gap
    observed: 7e-16."""
    (_, ja), (_, ta) = models(seed=12)
    rng = np.random.default_rng(13)
    V = np.concatenate([np.asarray(ja.X[:2]),
                        np.stack([rng.uniform(0, 2 * np.pi, 5),
                                  rng.uniform(-1, 1, 5)], 1)])
    mj, vj = jpr.predict_aux(ja, jnp.asarray(V))
    mt, vt = tpr.predict_aux(ta, t64(V))
    assert mt.shape == (7,) and vt.shape == (7,)
    close(mt, mj)
    close(vt, vj)
    assert tpr.predict_aux(ta, t64(V), with_var=False)[1] is None


def test_predict_needs_a_dense_factor():
    """A model without a Cholesky factor (the large-N fit's) gives means
    but refuses variances."""
    (_, _), (ts, _) = models(seed=14)
    m = TSympGP.from_alpha(ts.kernel, ts.params, ts.sig, ts.sig2n, ts.X,
                           ts.z, ts.alpha)
    V = t64([[0.5, 0.1], [2.0, -0.3]])
    with pytest.raises(ValueError, match="dense Cholesky factor"):
        tpr.predict_df(m, V)
    close(tpr.predict_df(m, V, with_var=False)[0],
          npy(tpr.predict_df(ts, V)[0]))
