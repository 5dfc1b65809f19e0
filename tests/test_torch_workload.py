"""PyTorch port vs JAX: the tokamak workload end to end at
``TokamakConfig(N=40)``, ``nm=30``, in both backends, against the JAX run
on the same inputs and against the gates of ``tests/test_workloads.py``
(``test_tokamak_single``, ``test_tokamak_pallas_backend``).

The two L-BFGS runs stop a few 1e-7 apart (see
``test_torch_likelihood.test_fits_match_jax``), so the float64
trajectories are held at 1e-5 and the metrics at 1e-4 relative.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, npy  # noqa: E402

from sympgpr_tpu.systems.tokamak import TokamakConfig as JCfg  # noqa: E402
from sympgpr_tpu.workloads import tokamak as jwl  # noqa: E402
from sympgpr_tpu_torch.systems.tokamak import TokamakConfig as TCfg  # noqa: E402,E501
from sympgpr_tpu_torch.systems import tokamak as ttk  # noqa: E402
from sympgpr_tpu_torch.workloads import tokamak as twl  # noqa: E402

NM = 30


@pytest.fixture(scope="module")
def jax_generic():
    return jwl.run(JCfg(N=40), nm=NM)


@pytest.fixture(scope="module")
def jax_pallas():
    return jwl.run(JCfg(N=40), nm=NM, backend="pallas")


@pytest.fixture(scope="module")
def port_generic():
    return twl.run(TCfg(N=40), nm=NM, device=CPU)


@pytest.fixture(scope="module")
def port_kernel():
    return twl.run(TCfg(N=40), nm=NM, backend="kernel", with_reference=False,
                   device=CPU)


def test_generic_gates(port_generic):
    out = port_generic
    assert out["training_error"] < 1e-12
    assert np.nanmean(out["gd"]) < 1e-2
    assert out["n_lost"] <= out["cfg"]["Ntest"] // 3
    assert out["traj"].q.shape == (NM, 30)
    assert out["traj"].q.dtype == torch.float64


def test_generic_matches_jax(port_generic, jax_generic):
    t, j = port_generic, jax_generic
    np.testing.assert_allclose(t["hyps"][0], j["hyps"][0], rtol=1e-4)
    np.testing.assert_allclose(t["sigs"][0], j["sigs"][0], rtol=1e-4)
    assert t["n_lost"] == j["n_lost"]
    np.testing.assert_allclose(npy(t["traj"].q), np.asarray(j["traj"].q),
                               atol=1e-5)
    np.testing.assert_allclose(npy(t["traj"].p), np.asarray(j["traj"].p),
                               atol=1e-5)
    np.testing.assert_allclose(t["Eosc"], j["Eosc"], rtol=1e-4)
    np.testing.assert_allclose(t["gd"], j["gd"], rtol=1e-4, atol=1e-12)


def test_reference_sections_match_jax(port_generic, jax_generic):
    """The nm-turn plotting reference: 960 midpoint steps, float64, no fit
    involved, so 1e-10."""
    t, j = port_generic["ref_sections"], jax_generic["ref_sections"]
    assert t.shape == j.shape == (NM + 1, 30, 3)
    np.testing.assert_allclose(t, j, rtol=1e-10, atol=1e-12)


def test_kernel_backend_gates(port_kernel):
    """Gate of test_tokamak_pallas_backend: median gd (one near-separatrix
    orbit of the weak N=40 model can deviate) and lost orbits."""
    out = port_kernel
    (r0, th0), _ = ttk.test_initial_conditions(TCfg(N=40))
    gd = twl.one_turn_gd(TCfg(N=40), out["traj"], r0, th0, CPU)["gd"]
    assert np.nanmedian(gd) < 2e-2
    assert out["n_lost"] <= out["cfg"]["Ntest"] // 3
    assert out["traj"].q.dtype == torch.float32
    assert out["backend"] == "kernel" and "gd" not in out


def test_kernel_backend_matches_jax_pallas(port_kernel, jax_pallas):
    """float32 rollouts of the two packages: steps 1-2 at 1e-4 (the
    tokamak model's deployment alpha is larger than the toys' of
    tests/test_pallas_step.py, and q runs up to 2 pi: 1e-4 is ~200 float32
    ulps of it), the energy statistics over all 30 steps at 1e-3 relative
    (chaotic decoherence leaves the statistics, not the orbits)."""
    t, j = port_kernel, jax_pallas
    for i in (1, 2):
        np.testing.assert_allclose(npy(t["traj"].q[i]),
                                   np.asarray(j["traj"].q[i]), atol=1e-4)
        np.testing.assert_allclose(npy(t["traj"].p[i]),
                                   np.asarray(j["traj"].p[i]), atol=1e-4)
    assert t["n_lost"] == j["n_lost"]
    np.testing.assert_allclose(np.nanmean(t["Eosc"]), np.nanmean(j["Eosc"]),
                               rtol=1e-3)


def test_run_rejects_what_is_not_ported():
    with pytest.raises(ValueError, match="backend"):
        twl.run(TCfg(N=40), nm=2, backend="pallas", device=CPU)
