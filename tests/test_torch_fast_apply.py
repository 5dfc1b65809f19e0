"""PyTorch port vs JAX: the factorized map-application fast path and the
quality metrics.

float64 models built by the JAX package and carried over through the
shared artifact keys, so both sides use the same alpha.  1e-12 relative,
the tolerance of ``tests/test_fast_apply.py``; over several map steps the
absolute floor is 1e-12 as well (the map moves orbits by O(1)).
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import jax_models_to_port, npy, t64, toy_data  # noqa: E402

from sympgpr_tpu.eval import metrics as jmet  # noqa: E402
from sympgpr_tpu.gp.model import AuxGP, SympGP  # noqa: E402
from sympgpr_tpu.kernels import variants as jvar  # noqa: E402
from sympgpr_tpu.maps import fast_apply as jfa  # noqa: E402
from sympgpr_tpu.maps.symplectic import MapConfig as JCfg  # noqa: E402
from sympgpr_tpu.systems.tokamak import TokamakConfig as JTok  # noqa: E402
from sympgpr_tpu.workloads.tokamak import make_loss_fn as jloss  # noqa: E402
from sympgpr_tpu_torch.eval import metrics as tmet  # noqa: E402
from sympgpr_tpu_torch.maps import fast_apply as tfa  # noqa: E402
from sympgpr_tpu_torch.maps.symplectic import MapConfig as TCfg  # noqa: E402
from sympgpr_tpu_torch.maps.symplectic import apply_map  # noqa: E402
from sympgpr_tpu_torch.systems.tokamak import TokamakConfig as TTok  # noqa: E402,E501
from sympgpr_tpu_torch.workloads.tokamak import make_loss_fn as tloss  # noqa: E402,E501

RTOL, ATOL = 1e-12, 1e-12


def models(name="per_se", seed=0, n=20):
    X, z, Xp, zp = toy_data(n, seed)
    k = jvar.get_kernel(name)
    params = jnp.asarray([0.9, 1.2, 0.55][: k.n_params])
    # jitter 1e-4 keeps |alpha| ~ 10: posterior sums then carry ~1e-14 of
    # summation-order rounding, below the 1e-12 tolerance
    sgp = SympGP.create(k, params, 1.5, 1e-4, jnp.asarray(X), jnp.asarray(z))
    aux = AuxGP.create(jvar.PER_SE, jnp.asarray([0.9, 1.2]), 1.5, 1e-4,
                       jnp.asarray(Xp), jnp.asarray(zp), delta=True)
    return (sgp, aux), jax_models_to_port(sgp, aux)


def batch(seed=1, b=24):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 2 * np.pi, b), rng.uniform(-0.5, 0.5, b)


def close(t, j):
    np.testing.assert_allclose(npy(t), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["per_se", "se_se", "per_se_freq"])
def test_step_pieces(name):
    (js, ja), (ts, ta) = models(name)
    q, p = batch()
    P = p + 0.01
    cj = jfa.precompute_step(js, jnp.asarray(q))
    ct = tfa.precompute_step(ts, t64(q))
    for a, b in zip(ct, cj):
        close(a, b)
    for a, b in zip(tfa.p_value_slope(ct, t64(P)),
                    jfa.p_value_slope(cj, jnp.asarray(P))):
        close(a, b)
    close(tfa.q_update(ct, t64(P)), jfa.q_update(cj, jnp.asarray(P)))
    close(tfa.aux_guess(ta, t64(q), t64(p)),
          jfa.aux_guess(ja, jnp.asarray(q), jnp.asarray(p)))


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "masked"])
def test_newton_P(fixed):
    (js, ja), (ts, ta) = models()
    q, p = batch(2)
    cj = jfa.precompute_step(js, jnp.asarray(q))
    ct = tfa.precompute_step(ts, t64(q))
    P0j = jfa.aux_guess(ja, jnp.asarray(q), jnp.asarray(p))
    P0t = tfa.aux_guess(ta, t64(q), t64(p))
    P0t[3] = torch.nan  # a lost lane stays frozen in both modes
    P0j = P0j.at[3].set(jnp.nan)
    Pj = jfa.newton_P(cj, jnp.asarray(p), P0j, 1e-12, 8, fixed)
    Pt = tfa.newton_P(ct, t64(p), P0t, 1e-12, 8, fixed)
    close(Pt, Pj)
    assert np.isnan(npy(Pt)[3])


def test_apply_map_fast_tokamak_loss():
    """Implicit map, masked Newton and the tokamak loss check at the old
    q (the generic backend of the workload)."""
    (js, ja), (ts, ta) = models(seed=3)
    q, p = batch(3)
    nm = 6
    tj = jfa.apply_map_fast(js, ja, jnp.asarray(q), jnp.asarray(p), nm,
                            JCfg(newton_tol=1e-12, newton_maxiter=20),
                            loss_pre=jloss(JTok(), use_new_q=False))
    tt = apply_map(ts, ta, t64(q), t64(p), nm,
                   TCfg(newton_tol=1e-12, newton_maxiter=20),
                   loss_pre=tloss(TTok(), use_new_q=False))
    assert tt.q.shape == (nm, 24) and tt.pdiff is None
    lost = np.isnan(npy(tt.p[-1]))
    assert 0 < lost.sum() < 24  # P < 0 orbits are poisoned
    close(tt.q, tj.q)
    close(tt.p, tj.p)


def test_apply_map_fast_fixed_iters_loss_post():
    (js, ja), (ts, ta) = models(seed=4)
    q, p = batch(4)
    cfg_kw = dict(newton_tol=1e-6, newton_maxiter=5)
    tj = jfa.apply_map_fast(js, ja, jnp.asarray(q), jnp.asarray(p), 5,
                            JCfg(**cfg_kw), fixed_iters=True,
                            loss_post=jloss(JTok(), use_new_q=True))
    tt = tfa.apply_map_fast(ts, ta, t64(q), t64(p), 5, TCfg(**cfg_kw),
                            fixed_iters=True,
                            loss_post=tloss(TTok(), use_new_q=True))
    close(tt.q, tj.q)
    close(tt.p, tj.p)


def test_apply_map_fast_explicit_and_sum_kernel():
    (js, ja), (ts, ta) = models(seed=5)
    q, p = batch(5)
    tj = jfa.apply_map_fast(js, ja, jnp.asarray(q), jnp.asarray(p), 4,
                            JCfg(explicit=True))
    tt = tfa.apply_map_fast(ts, ta, t64(q), t64(p), 4, TCfg(explicit=True))
    close(tt.q, tj.q)
    close(tt.p, tj.p)
    (js, _), (ts, _) = models("sum_per_se", seed=6)
    cfg = dict(explicit=True, mod_p=2 * np.pi, track_pdiff=True)
    tj = jfa.apply_map_fast(js, None, jnp.asarray(q), jnp.asarray(p), 4,
                            JCfg(**cfg))
    tt = tfa.apply_map_fast(ts, None, t64(q), t64(p), 4, TCfg(**cfg))
    for a, b in zip(tt, tj):
        close(a, b)
    with pytest.raises(ValueError, match="explicit"):
        tfa.apply_map_fast(ts, None, t64(q), t64(p), 2, TCfg())


def test_metrics():
    rng = np.random.default_rng(7)
    H = 1.0 + 0.01 * rng.standard_normal((50, 6))
    H[10:, 2] = np.nan  # a lost orbit
    H[:, 4] = np.nan  # lost from the start
    np.testing.assert_allclose(
        npy(tmet.energy_oscillation(t64(H), dim=0)),
        np.asarray(jmet.energy_oscillation(jnp.asarray(H), axis=0)),
        rtol=RTOL, equal_nan=True)
    a = rng.uniform(0, 2 * np.pi, (4, 9))
    for mod_q in (None, 2 * np.pi):
        for x, y in zip(
                tmet.geometric_distance(*map(t64, a), mod_q=mod_q),
                jmet.geometric_distance(*map(jnp.asarray, a), mod_q=mod_q)):
            close(x, y)
    close(tmet.training_mse(t64(a[0]), t64(a[1])),
          jmet.training_mse(jnp.asarray(a[0]), jnp.asarray(a[1])))


def test_energy_oscillation_takes_axis():
    """``axis=`` (the JAX package's keyword, which the headline benchmark
    passes) is ``dim=``: both axes against JAX's ``energy_oscillation(H,
    axis=...)``, lost samples left out; the default is axis 0; both
    keywords at once are refused."""
    rng = np.random.default_rng(8)
    H = 1.0 + 0.01 * rng.standard_normal((40, 5))
    H[7:, 1] = np.nan
    for axis in (0, 1):
        want = np.asarray(jmet.energy_oscillation(jnp.asarray(H), axis=axis))
        for got in (tmet.energy_oscillation(t64(H), axis=axis),
                    tmet.energy_oscillation(t64(H), dim=axis)):
            np.testing.assert_allclose(npy(got), want, rtol=RTOL,
                                       equal_nan=True)
    np.testing.assert_array_equal(npy(tmet.energy_oscillation(t64(H))),
                                  npy(tmet.energy_oscillation(t64(H),
                                                              axis=0)))
    with pytest.raises(TypeError, match="not both"):
        tmet.energy_oscillation(t64(H), dim=0, axis=0)
