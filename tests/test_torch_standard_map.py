"""PyTorch port vs JAX: the Chirikov standard map (system, separable fit,
the implicit and explicit workloads, the large-N workload), on the CPU.

Inputs are the systems' own (Halton points, the seed-0 test ICs); both
packages run in float64, except the kernel backends (float32 on both
sides: the port's plain version of the rollout kernel, the Pallas kernel
in interpret mode).  The two L-BFGS searches stop a few ulps of their
tolerances apart, so fitted hyperparameters agree at rtol 1e-5 and what
follows from them at the tolerance stated in each test.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import math  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, npy, t64  # noqa: E402

from sympgpr_tpu.gp import likelihood as jlik  # noqa: E402
from sympgpr_tpu.gp import train as jtrain  # noqa: E402
from sympgpr_tpu.kernels import SUM_PER_SE as JSUM  # noqa: E402
from sympgpr_tpu.systems import standard_map as jsm  # noqa: E402
from sympgpr_tpu.workloads import standard_map as jwl  # noqa: E402
from sympgpr_tpu_torch.gp import likelihood as tlik  # noqa: E402
from sympgpr_tpu_torch.gp import train as ttrain  # noqa: E402
from sympgpr_tpu_torch.kernels import SUM_PER_SE  # noqa: E402
from sympgpr_tpu_torch.systems import standard_map as tsm  # noqa: E402
from sympgpr_tpu_torch.workloads import standard_map as twl  # noqa: E402

CFG = dict(nm=20)  # the reduced size of tests/test_workloads.py


def test_iterate_matches_jax():
    rng = np.random.default_rng(0)
    q0, p0 = rng.uniform(0, 2 * np.pi, (2, 16))
    qj, pj = jsm.iterate(jnp.asarray(q0), jnp.asarray(p0), 2.0, 12)
    qt, pt = tsm.iterate(t64(q0), t64(p0), 2.0, 12)
    assert qt.shape == (13, 16)
    # the same float64 operations; XLA's sin and PyTorch's differ in the
    # last bit now and then, which the chaotic map amplifies with the steps
    np.testing.assert_allclose(npy(qt), np.asarray(qj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(npy(pt), np.asarray(pj), rtol=0, atol=1e-12)


def test_training_data_and_ics_match_jax():
    cfg_j, cfg_t = jsm.StandardMapConfig(N=37), tsm.StandardMapConfig(N=37)
    dj, dt = jsm.training_data(cfg_j), tsm.training_data(cfg_t, CPU)
    for k in ("X", "z", "Xp", "zp", "q", "p", "Q", "P"):
        assert dt[k].dtype == torch.float64
        np.testing.assert_allclose(npy(dt[k]), np.asarray(dj[k]),
                                   rtol=1e-12, atol=1e-12)
    for a, b in zip(tsm.test_initial_conditions(tsm.StandardMapConfig()),
                    jsm.test_initial_conditions(jsm.StandardMapConfig())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("block", [0, 1])
@pytest.mark.parametrize("sig2n,rtol", [(1e-6, 1e-10), (1e-8, 1e-8)])
def test_nll_separable_matches_jax(block, sig2n, rtol):
    """Both diagonal blocks at 1e-10; at the fit's jitter 1e-8 a block's
    condition number turns the ulps in which the two autodiff builds of K
    differ into ~2e-9 of the NLL, so 1e-8 there."""
    d = jsm.training_data(jsm.StandardMapConfig())
    n = d["X"].shape[0]
    zb = d["z"][:n] if block == 0 else d["z"][n:]
    params = [1.7, 0.8]
    vj = jlik.nll_separable(JSUM, jnp.asarray(params), jnp.asarray(5.0),
                            jnp.asarray(sig2n), jnp.asarray(d["X"]),
                            jnp.asarray(zb), block)
    vt = tlik.nll_separable(SUM_PER_SE, t64(params), t64(5.0), t64(sig2n),
                            t64(d["X"]), t64(zb), block)
    np.testing.assert_allclose(float(vt), float(vj), rtol=rtol)


def test_fit_sympgp_separable_matches_jax():
    d = jsm.training_data(jsm.StandardMapConfig())
    sig = 2.0 * float(np.max(np.abs(d["z"])) ** 2)
    kw = dict(sig2n=1e-12, nll_sig2n=1e-8, x0_q=(1.0,), x0_p=(1.0,),
              fixed_sig=sig)
    mj, (rqj, rpj) = jtrain.fit_sympgp_separable(
        JSUM, jnp.asarray(d["X"]), jnp.asarray(d["z"]), **kw)
    mt, (rqt, rpt) = ttrain.fit_sympgp_separable(
        SUM_PER_SE, t64(d["X"]), t64(d["z"]), **kw)
    np.testing.assert_allclose(npy(mt.params), np.asarray(mj.params),
                               rtol=1e-5)
    np.testing.assert_allclose([rqt.fun, rpt.fun], [rqj.fun, rpj.fun],
                               rtol=1e-8)
    assert float(mt.training_error()) < 1e-10


@pytest.mark.parametrize("method", ["implicit", "explicit"])
def test_run_generic_matches_jax(method):
    """float64 fast path: hyperparameters at 1e-5, the one-step MSE at
    1e-3 (5.7e-8 and 4.6e-13 at this size), the first mapped point and its
    pdiff at 1e-6; the gates of tests/test_workloads.py."""
    oj = jwl.run(jsm.StandardMapConfig(**CFG), method=method)
    ot = twl.run(tsm.StandardMapConfig(**CFG), method=method, device=CPU)
    np.testing.assert_allclose(ot["hyp"], oj["hyp"], rtol=1e-5)
    assert ot["training_error"] < 1e-10
    assert ot["one_step_mse"] < (1e-5 if method == "implicit" else 1e-8)
    np.testing.assert_allclose(ot["one_step_mse"], oj["one_step_mse"],
                               rtol=1e-3)
    tj, tt = oj["traj"], ot["traj"]
    assert tt.q.dtype == torch.float64 and tt.pdiff.shape == (20, 30)
    for a, b in ((tt.q, tj.q), (tt.p, tj.p), (tt.pdiff, tj.pdiff)):
        np.testing.assert_allclose(npy(a[:2]), np.asarray(b[:2]), atol=1e-6)
    np.testing.assert_allclose(ot["q_ref"], oj["q_ref"], rtol=1e-12)


@pytest.mark.parametrize("method", ["implicit", "explicit"])
def test_run_kernel_backend_matches_pallas(method):
    """float32 fused rollout (the port's plain version on the CPU) against
    the Pallas backend: the one-step MSE within 5 % (float32 summation
    order) and under the JAX Pallas gates, P wrapped into [0, 2 pi), pdiff
    unwrapped and equal to P where nothing wrapped."""
    oj = jwl.run(jsm.StandardMapConfig(**CFG), method=method,
                 backend="pallas")
    ot = twl.run(tsm.StandardMapConfig(**CFG), method=method,
                 backend="kernel", device=CPU)
    assert ot["one_step_mse"] < (1e-4 if method == "implicit" else 1e-5)
    np.testing.assert_allclose(ot["one_step_mse"], oj["one_step_mse"],
                               rtol=0.05)
    traj = ot["traj"]
    assert traj.q.dtype == torch.float32 and traj.pdiff is not None
    P, D = npy(traj.p[1:]), npy(traj.pdiff[1:])
    # [0, 2 pi), whose top float32 rounds to fl(2 pi)
    assert np.nanmin(P) >= 0 and np.nanmax(P) <= np.float32(2 * np.pi)
    # pdiff - P is a whole number of turns
    turns = (D - P) / (2 * np.pi)
    np.testing.assert_allclose(turns, np.round(turns), atol=1e-4)
    assert np.abs(turns).max() >= 1
    np.testing.assert_allclose(npy(traj.pdiff[1]),
                               np.asarray(oj["traj"].pdiff[1]), atol=5e-5)


def test_run_large_reduced():
    """The large-N workload at the reduced size of tests/test_workloads.py
    (N = 192, 20 Adam steps, float64 on the CPU): its gates, and the NLL
    history's ends against JAX's at 1e-8 (the same closed-form gradient,
    the same Adam)."""
    kw = dict(n_train=192, nm=10, steps=20, aux_subsample=96, sig2n=1e-4)
    out = twl.run_large(**kw, device=CPU)
    assert out["dtype"] == "float64"
    assert out["nll_decreased"]
    assert out["one_step_mse"] < 1e-4, out["one_step_mse"]
    assert out["finite_frac"] == 1.0 and out["pdiff_finite"]
    oj = jwl.run_large(**kw)
    np.testing.assert_allclose([out["nll_first"], out["nll_last"]],
                               [oj["nll_first"], oj["nll_last"]], rtol=1e-8)
    np.testing.assert_allclose(out["hyp"], oj["hyp"], rtol=1e-8)
    np.testing.assert_allclose(out["one_step_mse"], oj["one_step_mse"],
                               rtol=0.05)


def test_one_step_mse_minimum_image():
    """The exact point shifted by whole turns is no error; half a turn in
    q is pi^2 / 2."""
    q0, p0 = t64([0.3, 1.0]), t64([0.5, 2.0])
    qr, pr = tsm.iterate(q0, p0, 2.0, 1)
    assert twl.one_step_mse(qr[1] + 2 * math.pi, pr[1] - 2 * math.pi, q0,
                            p0, 2.0) < 1e-20
    assert twl.one_step_mse(qr[1] + math.pi, pr[1], q0, p0,
                            2.0) == pytest.approx(math.pi**2 / 2)
