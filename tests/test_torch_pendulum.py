"""PyTorch port vs JAX: the pendulum (system, energy, the implicit,
explicit and period-unknown workloads), on the CPU.

Inputs are the systems' own (Halton points, the seed-1 test ICs) or made
with numpy from a seed; float64 on both sides, except the kernel backends
(float32 on both sides: the port's plain version of the rollout kernel,
the Pallas kernel in interpret mode).  The workloads run at the reduced
sizes of ``tests/test_workloads.py``.  Two L-BFGS searches stop a little
apart (rtol ~2e-5 in the lengthscales here), so workload outputs are held at
the tolerance stated in each test.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, npy, t64  # noqa: E402

from sympgpr_tpu.eval import metrics as jmet  # noqa: E402
from sympgpr_tpu.systems import pendulum as jpend  # noqa: E402
from sympgpr_tpu.workloads import pendulum_explicit as jpe  # noqa: E402
from sympgpr_tpu.workloads import pendulum_implicit as jpi  # noqa: E402
from sympgpr_tpu.workloads import pendulum_period_unknown as jpu  # noqa: E402
from sympgpr_tpu_torch.eval import metrics as tmet  # noqa: E402
from sympgpr_tpu_torch.systems import pendulum as tpend  # noqa: E402
from sympgpr_tpu_torch.workloads import pendulum_explicit as tpe  # noqa: E402
from sympgpr_tpu_torch.workloads import pendulum_implicit as tpi  # noqa: E402
from sympgpr_tpu_torch.workloads import pendulum_period_unknown as tpu  # noqa: E402,E501


def _ics(seed=0, b=9):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 2 * np.pi, b), rng.uniform(-2, 2, b)


@pytest.mark.parametrize("save_every", [0, 25])
def test_integrate_rk4_matches_jax(save_every):
    q0, p0 = _ics(1)
    yj = jpend.integrate_rk4(jnp.asarray(q0), jnp.asarray(p0), 0.7, 100,
                             save_every)
    yt = tpend.integrate_rk4(t64(q0), t64(p0), 0.7, 100, save_every)
    assert yt.shape == ((5, 9, 2) if save_every else (9, 2))
    np.testing.assert_allclose(npy(yt), np.asarray(yj), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="multiple"):
        tpend.integrate_rk4(t64(q0), t64(p0), 0.7, 100, 30)


def test_symplectic_euler_and_energy_match_jax():
    q0, p0 = _ics(2)
    qj, pj = jpend.symplectic_euler(jnp.asarray(q0), jnp.asarray(p0), 4e-3,
                                    200)
    qt, pt = tpend.symplectic_euler(t64(q0), t64(p0), 4e-3, 200)
    assert qt.shape == (201, 9)
    np.testing.assert_allclose(npy(qt), np.asarray(qj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(npy(pt), np.asarray(pj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        npy(tmet.pendulum_energy(qt, pt, 1.3)),
        np.asarray(jmet.pendulum_energy(qj, pj, 1.3)), rtol=0, atol=1e-12)


def test_training_data_and_ics_match_jax():
    cfg_j = jpend.PendulumConfig(N=23, Nm=70)
    cfg_t = tpend.PendulumConfig(N=23, Nm=70)
    dj, dt = jpend.training_data(cfg_j), tpend.training_data(cfg_t, CPU)
    for k in ("X", "z", "Xp", "zp", "q", "p", "Q", "P"):
        assert dt[k].dtype == torch.float64
        np.testing.assert_allclose(npy(dt[k]), np.asarray(dj[k]), rtol=0,
                                   atol=1e-12)
    assert dt["t_map"] == dj["t_map"]
    for a, b in zip(tpend.test_initial_conditions(cfg_t),
                    jpend.test_initial_conditions(cfg_j)):
        np.testing.assert_array_equal(a, b)


def test_rk4_against_scipy():
    """The batched RK4 against the reference-parity solve_ivp over one map
    time (RK4's own error at 10x the reference's grid: ~1e-13)."""
    q0, p0 = _ics(3, b=3)
    t = np.array([0.0, 0.2])
    ref = tpend.integrate_scipy(q0, p0, t)
    y = tpend.integrate_rk4(t64(q0), t64(p0), 0.2, 2000)
    np.testing.assert_allclose(npy(y), ref[:, :, -1], rtol=0, atol=1e-11)


def _hold(ot, oj, rtol_hyp=1e-4):
    np.testing.assert_allclose(ot["hyp"], np.asarray(oj["hyp"]),
                               rtol=rtol_hyp)
    assert ot["traj"].q.shape == oj["traj"].q.shape


def test_implicit_generic_matches_jax():
    """float64 (nm = 30, with the one-map-time reference and the
    symplectic-Euler comparator): Eosc at rtol 1e-3 (6.0e-6), gd within
    10 % (1e-11, set by the hyperparameters' last digits), Eosc_se at
    1e-10."""
    kw = dict(with_reference=True, with_comparator=True)
    oj = jpi.run(jpend.PendulumConfig(nm=30), **kw)
    ot = tpi.run(tpend.PendulumConfig(nm=30), **kw, device=CPU)
    _hold(ot, oj)
    assert ot["training_error"] < 1e-10
    np.testing.assert_allclose(np.nanmean(ot["Eosc"]),
                               np.nanmean(oj["Eosc"]), rtol=1e-3)
    np.testing.assert_allclose(np.nanmean(ot["gd"]), np.nanmean(oj["gd"]),
                               rtol=0.1)
    np.testing.assert_allclose(ot["Eosc_se"], oj["Eosc_se"], rtol=1e-10)
    assert ot["t_apply_se"] > 0


def test_implicit_kernel_backend_matches_pallas():
    """float32 (the JAX Pallas backend's gate, Eosc < 2e-3): within 5 %
    of the Pallas kernel's Eosc."""
    kw = dict(with_reference=False, with_comparator=False)
    oj = jpi.run(jpend.PendulumConfig(nm=30), backend="pallas", **kw)
    ot = tpi.run(tpend.PendulumConfig(nm=30), backend="kernel", **kw,
                 device=CPU)
    assert ot["traj"].q.dtype == torch.float32
    assert float(np.nanmean(ot["Eosc"])) < 2e-3
    np.testing.assert_allclose(np.nanmean(ot["Eosc"]),
                               np.nanmean(oj["Eosc"]), rtol=0.05)


@pytest.mark.parametrize("backend", ["generic", "kernel"])
def test_explicit_matches_jax(backend):
    """sum_per_se fitted by fit_sympgp, Algorithm 2: the gates of
    tests/test_workloads.py (training error < 1e-10, Eosc < 0.2); Eosc at
    rtol 1e-6 in float64 (0.039) and within 5 % in float32 (the kernel's
    kind-3 mode against the Pallas kernel's)."""
    nm = 100 if backend == "generic" else 30
    oj = jpe.run(jpend.PendulumConfig(Nm=70, sig2_n=1e-10, nm=nm),
                 backend="pallas" if backend == "kernel" else "generic")
    ot = tpe.run(tpend.PendulumConfig(Nm=70, sig2_n=1e-10, nm=nm),
                 backend=backend, device=CPU)
    _hold(ot, oj, rtol_hyp=1e-6)
    assert ot["training_error"] < 1e-10
    assert float(np.nanmean(ot["Eosc"])) < 0.2
    np.testing.assert_allclose(np.nanmean(ot["Eosc"]),
                               np.nanmean(oj["Eosc"]),
                               rtol=1e-6 if backend == "generic" else 0.05)


def test_period_unknown_matches_jax():
    """per_se_freq (nm = 100, float64): the periodicity recovered as an
    integer multiple of 2 pi (the JAX gate), period_ratio at 1e-5, Eosc
    at 1e-3 (1.8e-5), training error < 1e-8."""
    cfg = dict(N=50, Nm=100, sig2_n=1e-10, nm=100)
    oj = jpu.run(jpend.PendulumConfig(**cfg))
    ot = tpu.run(tpend.PendulumConfig(**cfg), device=CPU)
    _hold(ot, oj)
    ratio = ot["period_ratio"]
    assert abs(ratio - round(ratio)) < 0.15 and 0.5 <= ratio <= 4.5
    np.testing.assert_allclose(ratio, oj["period_ratio"], rtol=1e-5)
    assert ot["training_error"] < 1e-8
    assert float(np.nanmean(ot["Eosc"])) < 1e-2
    np.testing.assert_allclose(np.nanmean(ot["Eosc"]),
                               np.nanmean(oj["Eosc"]), rtol=1e-3)
