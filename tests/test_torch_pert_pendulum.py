"""PyTorch port vs JAX: the perturbed pendulum (system and workload), on
the CPU.

The system's inputs are its own (Halton disc points, the line ICs);
float64 on both sides, 1e-12.  The workload runs at the reduced size of
``tests/test_workloads.py`` (nm = 20): float64 on the generic backends,
float32 on the kernel backends (the port's plain version of the rollout
kernel, the Pallas kernel in interpret mode).  Two L-BFGS searches stop a
little apart (rtol ~3e-6 in the lengthscales here), so workload outputs
are held at the tolerance stated in each test; a JAX-fitted model rolled
out by both packages tells a fit difference from a map difference.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, jax_models_to_port, npy, t64  # noqa: E402

from sympgpr_tpu.gp.model import SympGP  # noqa: E402
from sympgpr_tpu.gp.train import fit_auxgp  # noqa: E402
from sympgpr_tpu.kernels import PER_SE  # noqa: E402
from sympgpr_tpu.maps import symplectic as jsm  # noqa: E402
from sympgpr_tpu.systems import pert_pendulum as jpp  # noqa: E402
from sympgpr_tpu.workloads import pert_pendulum as jwl  # noqa: E402
from sympgpr_tpu_torch.maps import symplectic as tsm  # noqa: E402
from sympgpr_tpu_torch.systems import pert_pendulum as tpp  # noqa: E402
from sympgpr_tpu_torch.workloads import pert_pendulum as twl  # noqa: E402

TOL = 1e-12


@pytest.fixture(scope="module")
def generic_runs():
    """Both packages' workloads at nm = 20 on their float64 paths."""
    return (jwl.run(jpp.PertPendulumConfig(nm=20)),
            twl.run(tpp.PertPendulumConfig(nm=20), device=CPU))


def test_rk_pmap_matches_jax():
    """One stroboscopic period (1500 RK4 steps) of 9 states, and of the
    unperturbed pendulum (e = 0), which must equal the om-pendulum's
    energy-conserving orbit.  1e-12 (largest gap observed: 7e-16; the
    port folds the perturbation's time factor into one host scalar per
    stage)."""
    rng = np.random.default_rng(0)
    z = rng.uniform(-0.8, 0.8, (9, 2))
    for e in (0.5, 0.0):
        zj = jpp.rk_pmap(jnp.asarray(z), e, 0.5, 1500)
        zt = tpp.rk_pmap(t64(z), e, 0.5, 1500)
        assert zt.shape == (9, 2) and zt.dtype == torch.float64
        np.testing.assert_allclose(npy(zt), np.asarray(zj), rtol=0,
                                   atol=TOL)
    # e = 0: the om-pendulum's energy is conserved over the period
    H = 0.5 * z[:, 1] ** 2 + 0.25 * (1 - np.cos(z[:, 0]))
    Ht = 0.5 * npy(zt[:, 1]) ** 2 + 0.25 * (1 - np.cos(npy(zt[:, 0])))
    np.testing.assert_allclose(Ht, H, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        npy(tpp.zdot(0.3, t64(z), 0.5, 0.5)),
        np.asarray(jpp.zdot(0.3, jnp.asarray(z), 0.5, 0.5)), rtol=0,
        atol=1e-15)


def test_training_data_and_ics_match_jax():
    """The disc samples, the filter to the disc, the pi shift and the
    absolute-P aux targets: 1e-12 (largest gap observed: 4.4e-16), the
    same points kept; the line ICs equal."""
    cj, ct = jpp.PertPendulumConfig(), tpp.PertPendulumConfig()
    np.testing.assert_array_equal(
        tpp.gen_samples_circle([0.0, 0.0], 0.9, 55),
        jpp.gen_samples_circle([0.0, 0.0], 0.9, 55))
    dj, dt = jpp.training_data(cj), tpp.training_data(ct, CPU)
    assert dt["n_data"] == dj["n_data"] and 0 < dt["n_data"] < 55
    for k in ("X", "z", "Xp", "zp", "q", "p", "Q", "P"):
        assert dt[k].dtype == torch.float64
        np.testing.assert_allclose(npy(dt[k]), np.asarray(dj[k]), rtol=0,
                                   atol=TOL)
    for a, b in zip(tpp.test_initial_conditions(ct),
                    jpp.test_initial_conditions(cj)):
        np.testing.assert_array_equal(a, b)
    assert ct.Ntest == 30


def test_reference_orbits_match_jax():
    """20 rows of the true stroboscopic map (100 RK4 steps a period) for
    the 30 line ICs: 1e-12 (largest gap observed: 1e-14)."""
    cfg_j, cfg_t = jpp.PertPendulumConfig(), tpp.PertPendulumConfig()
    q0, p0 = tpp.test_initial_conditions(cfg_t)
    qj, pj = jpp.reference_orbits(cfg_j, q0, p0, 20)
    qt, pt = tpp.reference_orbits(cfg_t, t64(q0), t64(p0), 20)
    assert qt.shape == (20, 30)
    np.testing.assert_array_equal(npy(qt[0]), q0)
    np.testing.assert_allclose(npy(qt), qj, rtol=0, atol=TOL)
    np.testing.assert_allclose(npy(pt), pj, rtol=0, atol=TOL)


def test_workload_generic_matches_jax(generic_runs):
    """float64 (nm = 20): the gates of tests/test_workloads.py (training
    error < 1e-10, one-step MSE < 1e-4), the hyperparameters at rtol 1e-4
    (observed 3e-6), the one-step MSE within 10 % of JAX's (observed
    1.08402e-7 both)."""
    oj, ot = generic_runs
    np.testing.assert_allclose(ot["hyp"], np.asarray(oj["hyp"]), rtol=1e-4)
    assert ot["n_train"] == oj["n_train"]
    assert ot["traj"].q.shape == (20, 30)
    assert ot["traj"].q.dtype == torch.float64
    assert ot["training_error"] < 1e-10
    assert ot["one_step_mse"] < 1e-4
    np.testing.assert_allclose(ot["one_step_mse"], oj["one_step_mse"],
                               rtol=0.1)
    assert ot["q_ref"].shape == (20, 30)


def test_jax_fitted_model_rolls_out_in_port(generic_runs):
    """JAX's fitted models (the symplectic GP at the JAX run's
    hyperparameters, the aux GP by JAX's fit) rolled out for 20 rows by
    both packages' float64 paths.  At jitter 1e-12 these models carry
    sig |alpha| up to 3.6e5, so two summation orders of the posterior sums
    (XLA's and PyTorch's) differ by ~4e-10 in pGP: one step from each of
    JAX's rows is held within 5e-9 (observed 1.6e-9), the 20-row
    trajectory within 2e-8 (observed 8.3e-9, growing ~4e-10 a row on
    these regular orbits), and the generic path over 4 rows within 5e-9
    (observed 2.1e-9).
    JAX's own rollout of the same models reproduces its run to 1e-10."""
    oj, _ = generic_runs
    cfg = jpp.PertPendulumConfig(nm=20)
    d = jpp.training_data(cfg)
    sig = 2.0 * float(np.max(np.abs(d["z"])) ** 2)
    sgp = SympGP.create(PER_SE, jnp.asarray(oj["hyp"]), sig, cfg.sig2_n,
                        jnp.asarray(d["X"]), jnp.asarray(d["z"]))
    aux, _ = fit_auxgp(
        PER_SE, jnp.asarray(d["Xp"]), jnp.asarray(d["zp"]),
        sig2n=cfg.sig2_n, x0=(0.5, 0.5),
        fixed_sig=2.0 * float(np.max(np.abs(d["zp"])) ** 2),
        transform="linear", delta=False)
    ts, ta = jax_models_to_port(sgp, aux)
    q0, p0 = jpp.test_initial_conditions(cfg)
    kw = dict(newton_tol=1e-12, newton_maxiter=20)
    tj = jsm.apply_map(sgp, aux, jnp.asarray(q0), jnp.asarray(p0), 20,
                       jsm.MapConfig(**kw))
    np.testing.assert_allclose(np.asarray(tj.q), np.asarray(oj["traj"].q),
                               rtol=0, atol=1e-10)
    qj, pj = np.asarray(tj.q), np.asarray(tj.p)
    step = tsm.apply_map(ts, ta, t64(qj[:-1].ravel()), t64(pj[:-1].ravel()),
                         2, tsm.MapConfig(**kw))
    np.testing.assert_allclose(npy(step.q[1]), qj[1:].ravel(), rtol=0,
                               atol=5e-9)
    np.testing.assert_allclose(npy(step.p[1]), pj[1:].ravel(), rtol=0,
                               atol=5e-9)
    for prefer_fast, nm, tol in ((True, 20, 2e-8), (False, 4, 5e-9)):
        tt = tsm.apply_map(ts, ta, t64(q0), t64(p0), nm,
                           tsm.MapConfig(**kw), prefer_fast=prefer_fast)
        for a, b in zip(tt[:2], (qj, pj)):
            np.testing.assert_allclose(npy(a), b[:nm], rtol=0, atol=tol)


def test_kernel_backend_matches_pallas():
    """float32 (nm = 20, deployment jitter 1e-5): the Pallas backend's
    gate (one-step MSE < 1e-3) and within 10 % of the Pallas kernel's
    (observed 2.99e-6 against 3.01e-6)."""
    oj = jwl.run(jpp.PertPendulumConfig(nm=20), backend="pallas")
    ot = twl.run(tpp.PertPendulumConfig(nm=20), backend="kernel",
                 device=CPU)
    assert ot["traj"].q.dtype == torch.float32
    assert ot["training_error"] < 1e-10
    assert ot["one_step_mse"] < 1e-3
    np.testing.assert_allclose(ot["one_step_mse"], oj["one_step_mse"],
                               rtol=0.1)
    with pytest.raises(ValueError, match="backend"):
        twl.run(tpp.PertPendulumConfig(nm=2), backend="pallas", device=CPU)
