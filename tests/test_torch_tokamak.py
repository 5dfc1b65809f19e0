"""PyTorch port vs JAX: the tokamak field-line system.

float64; 1e-12 relative (the JAX package's own covariance-test tolerance).  The
port's midpoint step uses a hand-written Jacobian where JAX uses jacfwd:
the Jacobian is held against ``torch.func.jacfwd`` of the same residual,
and the integrated orbits against JAX.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, npy, t64  # noqa: E402

from sympgpr_tpu.systems import tokamak as jtk  # noqa: E402
from sympgpr_tpu_torch.systems import tokamak as ttk  # noqa: E402

RTOL, ATOL = 1e-12, 1e-14


def _orbit_states(seed=0, b=16):
    """(b, 3) states (pth, th, ph) inside the confined region."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.1, 0.36, b)
    th = rng.uniform(0, 2 * np.pi, b)
    ph = rng.uniform(0, 2 * np.pi, b)
    return r, th, ph


def test_test_initial_conditions_identical():
    for cfg in (jtk.TokamakConfig(), jtk.TokamakConfig(Ntest=7)):
        tcfg = ttk.TokamakConfig(Ntest=cfg.Ntest)
        for a, b in zip(ttk.test_initial_conditions(tcfg),
                        jtk.test_initial_conditions(cfg)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_compute_r_and_potentials():
    r, th, ph = _orbit_states(1)
    pth = np.asarray(jtk.Ath(r, th, ph))
    field = jtk.TokamakField()
    tfield = ttk.TokamakField()
    np.testing.assert_allclose(npy(ttk.Ath(t64(r), t64(th), t64(ph))), pth,
                               rtol=RTOL)
    rj = jtk.compute_r(jnp.asarray(pth), jnp.asarray(th), jnp.asarray(ph),
                       jnp.full_like(jnp.asarray(pth), 0.3))
    rt = ttk.compute_r(t64(pth), t64(th), t64(ph), torch.full((16,), 0.3,
                                                              dtype=torch.float64))
    np.testing.assert_allclose(npy(rt), np.asarray(rj), rtol=RTOL)
    np.testing.assert_allclose(npy(rt), r, rtol=1e-10)  # recovers r
    for fj, ft in ((jtk.dAphdr, ttk.dAphdr), (jtk.dAphdth, ttk.dAphdth),
                   (jtk.Aph, ttk.Aph)):
        np.testing.assert_allclose(
            npy(ft(tfield, t64(r), t64(th), t64(ph))),
            np.asarray(fj(field, r, th, ph)), rtol=RTOL, atol=ATOL)


def test_field_energy():
    r, th, _ = _orbit_states(2)
    p = np.asarray(jtk.Ath(r, th, 0.0)) * 1e2
    Hj = jtk.field_energy(jtk.TokamakField(), jnp.asarray(th), jnp.asarray(p))
    Ht = ttk.field_energy(ttk.TokamakField(), t64(th), t64(p))
    np.testing.assert_allclose(npy(Ht), np.asarray(Hj), rtol=RTOL)


def test_step_jacobian_matches_jacfwd():
    """Hand-written Jacobian vs torch.func.jacfwd through the 20-step
    Newton for r (what the JAX package differentiates)."""
    r, th, ph = _orbit_states(3)
    field = ttk.TokamakField(eps=0.01)
    dph = 2 * np.pi / 32
    pth = ttk.Ath(t64(r), t64(th), 0.0)
    zold = torch.stack([pth, t64(th), t64(ph)], -1)
    rng = np.random.default_rng(4)
    znew = zold[:, :2] + t64(rng.uniform(-1e-3, 1e-3, (16, 2)))
    rlast = t64(r)

    def res1(zn, zo, rl):
        return ttk._tstep_residual(field, dph, zn[None], zo[None],
                                   rl[None])[0][0]

    Jad = torch.func.vmap(torch.func.jacfwd(res1))(znew, zold, rlast)
    _, rmid = ttk._tstep_residual(field, dph, znew, zold, rlast)
    Jh = ttk._tstep_jacobian(field, dph, znew, zold, rmid)
    np.testing.assert_allclose(npy(Jh), npy(Jad), rtol=RTOL, atol=1e-15)


def test_timestep_matches_jax():
    r, th, ph = _orbit_states(5)
    field = jtk.TokamakField()
    dph = 2 * np.pi / 32
    pth = np.asarray(jtk.Ath(r, th, 0.0))
    z = np.stack([pth, th, ph], -1)
    zj, rj = jax.vmap(lambda zz, rr: jtk.timestep(field, dph, zz, rr))(
        jnp.asarray(z), jnp.asarray(r))
    zt, rt = ttk.timestep(ttk.TokamakField(), dph, t64(z), t64(r))
    np.testing.assert_allclose(npy(zt), np.asarray(zj), rtol=RTOL)
    np.testing.assert_allclose(npy(rt), np.asarray(rj), rtol=RTOL)


def test_training_data_matches_jax():
    """TokamakConfig(N=40): 64 midpoint steps of 40 field lines."""
    dj = jtk.training_data(jtk.TokamakConfig(N=40))
    dt = ttk.training_data(ttk.TokamakConfig(N=40), CPU)
    for k in ("q", "p", "Q", "P"):
        assert dt[k].shape == (40, 1) and dt[k].dtype == torch.float64
        np.testing.assert_allclose(npy(dt[k]), dj[k], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(npy(dt["traj"]), dj["traj"], rtol=RTOL,
                               atol=ATOL)


def test_reference_orbits_and_save_every():
    (r0, th0), _ = jtk.test_initial_conditions(jtk.TokamakConfig(Ntest=6))
    cfg_t = ttk.TokamakConfig(Ntest=6)
    ref_j = jtk.reference_orbits(jtk.TokamakConfig(Ntest=6), r0, th0, 1)
    ref_t = ttk.reference_orbits(cfg_t, r0, th0, 1, CPU)
    np.testing.assert_allclose(npy(ref_t), np.asarray(ref_j), rtol=RTOL,
                               atol=ATOL)
    pth0, th0_t = ttk.ics_to_pth(r0, th0, CPU)
    every = ttk.integrate_fieldlines(cfg_t.field, pth0, th0_t,
                                     torch.zeros(6, dtype=torch.float64),
                                     32, 32, t64(r0), save_every=8)
    assert every.shape == (5, 6, 3)
    np.testing.assert_array_equal(npy(every), npy(ref_t[::8]))
    with pytest.raises(ValueError):
        ttk.integrate_fieldlines(cfg_t.field, pth0, th0_t, th0_t, 32, 10,
                                 t64(r0), save_every=3)


def test_fieldline_rhs_and_rk4_match_jax():
    """The explicit field-line ODE and the RK4 cross-integrator, 16 field
    lines over two turns of 32 steps: 1e-12 relative (largest absolute gap
    observed: 7e-15).  The RK4 and the midpoint integrator agree to their
    truncation error, as the JAX package's test_systems.py holds."""
    r, th, ph = _orbit_states(6)
    field_j, field_t = jtk.TokamakField(), ttk.TokamakField()
    pth = np.asarray(jtk.Ath(r, th, 0.0))
    y = np.stack([pth, th], -1)
    kj, rj = jax.vmap(lambda zz, p, rr: jtk._fieldline_rhs(
        field_j, zz, p, rr))(jnp.asarray(y), jnp.asarray(ph), jnp.asarray(r))
    kt, rt = ttk._fieldline_rhs(field_t, t64(y), t64(ph), t64(r))
    np.testing.assert_allclose(npy(kt), np.asarray(kj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(npy(rt), np.asarray(rj), rtol=RTOL)
    zero = np.zeros_like(r)
    tj = jtk.integrate_fieldlines_rk4(field_j, jnp.asarray(pth),
                                      jnp.asarray(th), jnp.asarray(zero), 32,
                                      64, jnp.asarray(r))
    tt = ttk.integrate_fieldlines_rk4(field_t, t64(pth), t64(th), t64(zero),
                                      32, 64, t64(r))
    assert tt.shape == (65, 16, 3) and tt.dtype == torch.float64
    np.testing.assert_allclose(npy(tt), np.asarray(tj), rtol=RTOL, atol=ATOL)
    mid = ttk.integrate_fieldlines(field_t, t64(pth), t64(th), t64(zero), 32,
                                   64, t64(r))
    assert float((tt - mid).abs().max()) < 1e-2


@pytest.mark.parametrize("eps, r", [(0.0, 0.15), (0.001, 0.25)])
def test_safety_factor_matches_jax(eps, r):
    """q = dphi/dtheta over 5 turns of the midpoint integrator: 1e-10
    relative to JAX (observed: equal to the bit)."""
    qj = jtk.safety_factor(jtk.TokamakField(eps=eps), r, n_turns=5)
    qt = ttk.safety_factor(ttk.TokamakField(eps=eps), r, n_turns=5,
                           device=CPU)
    assert isinstance(qt, float) and 1.0 < qt < 2.0
    np.testing.assert_allclose(qt, qj, rtol=1e-10)
