"""PyTorch port vs JAX: the Henon-Heiles system (event-detected Poincare
sections) and its workload, on the CPU.

The port finds the section crossings from the stored RK4 states and
polishes all of them at once, where JAX polishes every orbit at every step
inside its scan: the cuts are held against JAX's at 1e-10 (unscaled), with
equal counts and NaN patterns.  The workload runs at the reduced size of
``tests/test_workloads.py`` (Ntest = 10, nm = 20): float64 on the generic
backends, float32 on the kernel backends (the port's plain version of the
rollout kernel, the Pallas kernel in interpret mode).
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, jax_models_to_port, npy, t64  # noqa: E402

from sympgpr_tpu.eval import metrics as jmet  # noqa: E402
from sympgpr_tpu.gp.model import SympGP  # noqa: E402
from sympgpr_tpu.gp.train import fit_auxgp  # noqa: E402
from sympgpr_tpu.kernels import SE_SE  # noqa: E402
from sympgpr_tpu.maps import symplectic as jsm  # noqa: E402
from sympgpr_tpu.systems import henon_heiles as jhh  # noqa: E402
from sympgpr_tpu.workloads import henon_heiles as jwl  # noqa: E402
from sympgpr_tpu_torch.eval import metrics as tmet  # noqa: E402
from sympgpr_tpu_torch.maps import symplectic as tsm  # noqa: E402
from sympgpr_tpu_torch.systems import henon_heiles as thh  # noqa: E402
from sympgpr_tpu_torch.workloads import henon_heiles as twl  # noqa: E402

CUT_TOL = 1e-10


def test_initial_conditions_identical():
    """The Halton training ICs and the seeded test ICs, exactly."""
    for n, nt in ((55, 37), (8, 10)):
        cj, ct = jhh.HenonConfig(N=n, Ntest=nt), thh.HenonConfig(N=n,
                                                                 Ntest=nt)
        np.testing.assert_array_equal(thh.training_ics(ct),
                                      jhh.training_ics(cj))
        np.testing.assert_array_equal(thh.test_ics(ct), jhh.test_ics(cj))
    assert thh.test_ics(thh.HenonConfig()).shape == (37, 4)


@pytest.mark.parametrize("which, n_steps, max_cuts",
                         [("training", 3000, 2), ("test", 3000, 6)])
def test_integrate_sections_matches_jax(which, n_steps, max_cuts):
    """Cuts (unscaled), crossing times and counts: 1e-10 (largest gaps
    observed: 3e-16 in the cuts, 4e-15 in the times).  Training ICs: more
    crossings than slots, so the first two of each orbit are kept; test
    ICs over 30 time units: fewer crossings than 6 slots, the rest NaN."""
    cfg_j, cfg_t = jhh.HenonConfig(N=8), thh.HenonConfig(N=8)
    z0 = (jhh.training_ics(cfg_j) if which == "training"
          else jhh.test_ics(jhh.HenonConfig(Ntest=10)))
    cj, tj, nj = jhh.integrate_sections(cfg_j, jnp.asarray(z0), n_steps,
                                        max_cuts)
    ct, tt, nt = thh.integrate_sections(cfg_t, t64(z0), n_steps, max_cuts)
    assert ct.shape == (max_cuts, len(z0), 4) and ct.dtype == torch.float64
    np.testing.assert_array_equal(npy(nt), np.asarray(nj))
    np.testing.assert_array_equal(npy(torch.isnan(ct)),
                                  np.isnan(np.asarray(cj)))
    np.testing.assert_allclose(npy(ct), np.asarray(cj), rtol=0,
                               atol=CUT_TOL)
    np.testing.assert_allclose(npy(tt), np.asarray(tj), rtol=0,
                               atol=CUT_TOL)
    if which == "training":
        assert int(nt.min()) == max_cuts
    else:
        assert int(nt.max()) < max_cuts
        assert torch.isnan(ct[-1]).all()


def test_sections_on_section_and_energy():
    """Mirrors tests/test_systems.py: |q1| < 1e-12 at the cuts, p1 > 0
    (rising crossings only), the energy at the cuts within 1e-11 of the
    start; the two energy functions agree with JAX's at 1e-15."""
    cfg = thh.HenonConfig(N=8)
    z0 = thh.training_ics(cfg)
    cuts, _, count = thh.integrate_sections(cfg, t64(z0), 3000, 2)
    assert int(count.min()) >= 2
    assert float(cuts[..., 0].abs().max()) < 1e-12
    assert float(cuts[..., 2].min()) > 0
    E0 = thh.energy(t64(z0), cfg.lam)
    Ec = thh.energy(cuts, cfg.lam)
    assert float((Ec - E0[None]).abs().max()) < 1e-11
    np.testing.assert_allclose(npy(tmet.henon_energy(cuts, 1.3)),
                               np.asarray(jmet.henon_energy(
                                   jnp.asarray(npy(cuts)), 1.3)),
                               rtol=0, atol=1e-15)
    np.testing.assert_array_equal(npy(tmet.henon_energy(cuts, cfg.lam)),
                                  npy(Ec))


def test_section_pairs_matches_jax():
    """The scaled section points of the test ICs (8 cuts, 7500 steps):
    1e-10 relative to the 1e2 scale (observed: 5e-14)."""
    cfg_j, cfg_t = jhh.HenonConfig(Ntest=10), thh.HenonConfig(Ntest=10)
    z0 = thh.test_ics(cfg_t)
    pj, nj = jhh.section_pairs(cfg_j, z0, 8)
    pt, nt = thh.section_pairs(cfg_t, z0, 8, CPU)
    assert pt.shape == (8, 10, 2)
    np.testing.assert_array_equal(npy(nt), nj)
    np.testing.assert_allclose(npy(pt), pj, rtol=0, atol=CUT_TOL * 1e2)


@pytest.fixture(scope="module")
def generic_runs():
    """Both packages' workloads at Ntest = 10, nm = 20, float64."""
    return (jwl.run(jhh.HenonConfig(Ntest=10), nm=20),
            twl.run(thh.HenonConfig(Ntest=10), nm=20, device=CPU))


def test_workload_generic_matches_jax(generic_runs):
    """float64: the gates of tests/test_workloads.py (training error <
    1e-12, one-step MSE < 1e-3 in scaled coordinates), the
    hyperparameters at rtol 1e-4 (observed: 2e-11 apart), the one-step
    MSE within 10 % of JAX's (observed 2.92955e-5 both)."""
    oj, ot = generic_runs
    np.testing.assert_allclose(ot["hyp"], np.asarray(oj["hyp"]), rtol=1e-4)
    assert ot["traj"].q.shape == (20, 10)
    assert ot["traj"].q.dtype == torch.float64
    assert ot["training_error"] < 1e-12
    assert ot["one_step_mse"] < 1e-3
    np.testing.assert_allclose(ot["one_step_mse"], oj["one_step_mse"],
                               rtol=0.1)
    np.testing.assert_allclose(npy(ot["ref_sections"]),
                               oj["ref_sections"], rtol=0,
                               atol=CUT_TOL * 1e2)


def test_jax_fitted_model_rolls_out_in_port(generic_runs):
    """JAX's fitted SE x SE models rolled out without a wrap of q by both
    packages' float64 paths over 20 rows: 1e-10 (observed 1.8e-12; the
    section coordinates are scaled to |q|, |P| up to ~15), and the generic
    path over 4 rows (observed 6.5e-13)."""
    oj, _ = generic_runs
    cfg = jhh.HenonConfig(Ntest=10)
    pts, _ = jhh.section_pairs(cfg, jhh.training_ics(cfg), 2)
    q, p, Q, P = pts[0, :, 0], pts[0, :, 1], pts[1, :, 0], pts[1, :, 1]
    X = np.stack([q, P], 1)
    z = np.concatenate([p - P, Q - q])
    sgp = SympGP.create(SE_SE, jnp.asarray(oj["hyp"]),
                        2.0 * float(np.max(np.abs(z)) ** 2), cfg.sig2_n,
                        jnp.asarray(X), jnp.asarray(z))
    zp = P - p
    aux, _ = fit_auxgp(SE_SE, jnp.asarray(np.stack([q, p], 1)),
                       jnp.asarray(zp), sig2n=cfg.sig2_n, x0=(0.0, 0.0),
                       fixed_sig=2.0 * float(np.max(np.abs(zp)) ** 2),
                       bounds=((-10, 1), (-10, 1)), delta=True)
    ts, ta = jax_models_to_port(sgp, aux)
    z0t = jhh.test_ics(cfg)
    q0, p0 = z0t[:, 1] * cfg.scale, z0t[:, 3] * cfg.scale
    kw = dict(mod_q=None, newton_tol=1e-12, newton_maxiter=20)
    tj = jsm.apply_map(sgp, aux, jnp.asarray(q0), jnp.asarray(p0), 20,
                       jsm.MapConfig(**kw))
    np.testing.assert_allclose(np.asarray(tj.q), np.asarray(oj["traj"].q),
                               rtol=0, atol=1e-10)
    for prefer_fast, nm in ((True, 20), (False, 4)):
        tt = tsm.apply_map(ts, ta, t64(q0), t64(p0), nm,
                           tsm.MapConfig(**kw), prefer_fast=prefer_fast)
        for a, b in zip(tt[:2], tj[:2]):
            np.testing.assert_allclose(npy(a), np.asarray(b)[:nm], rtol=0,
                                       atol=1e-10)


def test_kernel_backend_matches_pallas():
    """float32 (deployment jitter 1e-3, no wrap of q): the Pallas backend's
    gate (one-step MSE < 2e-3 in scaled coordinates) and within 10 % of the
    Pallas kernel's (observed 4.0626e-4 against 4.0627e-4)."""
    oj = jwl.run(jhh.HenonConfig(Ntest=10), nm=20, backend="pallas",
                 with_reference=True)
    ot = twl.run(thh.HenonConfig(Ntest=10), nm=20, backend="kernel",
                 device=CPU)
    assert ot["traj"].q.dtype == torch.float32
    assert ot["training_error"] < 1e-12
    assert ot["one_step_mse"] < 2e-3
    np.testing.assert_allclose(ot["one_step_mse"], oj["one_step_mse"],
                               rtol=0.1)
    with pytest.raises(ValueError, match="backend"):
        twl.run(thh.HenonConfig(Ntest=2), nm=2, backend="pallas",
                device=CPU)
