"""PyTorch port vs JAX: the Split tokamak workload (``nphmap`` = 4
sub-maps of a quarter turn each, fitted with CMA-ES) at a small
configuration, in both backends, against the JAX run on the same inputs
and against the gates of ``tests/test_workloads.py`` (``test_tokamak_split``,
``test_tokamak_split_pallas_backend``).

The two CMA-ES searches follow the same draws; they end within ~1e-6
relative of each other (measured: 7e-7 on the hyperparameters), so, as in
``test_torch_workload.py``, the float64 trajectories are held at 1e-5 (they
land 2.2e-7 apart), the metrics at 1e-4 relative, float32 steps 1-2 at 1e-4
(7.6e-6 apart) and the lost orbits equal.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, npy  # noqa: E402

from sympgpr_tpu.systems import tokamak as jtk  # noqa: E402
from sympgpr_tpu.workloads import tokamak as jwl  # noqa: E402
from sympgpr_tpu_torch.systems import tokamak as ttk  # noqa: E402
from sympgpr_tpu_torch.workloads import tokamak as twl  # noqa: E402

# the JAX tokamak_split's shapes (nphmap 4, r_scale 0.38, the map's q
# range), fewer points and steps a turn
SPLIT = dict(N=24, nphmap=4, nph=32, r_scale=0.38, qminmap=0.16,
             qmaxmap=0.31)
NM = 12  # three turns of four sub-map steps


@pytest.fixture(scope="module")
def jax_generic():
    return jwl.run(jtk.TokamakConfig(**SPLIT), optimizer="cmaes", nm=NM)


@pytest.fixture(scope="module")
def jax_pallas():
    return jwl.run(jtk.TokamakConfig(**SPLIT), optimizer="cmaes", nm=NM,
                   backend="pallas", with_reference=False)


@pytest.fixture(scope="module")
def port_generic():
    return twl.run(ttk.TokamakConfig(**SPLIT), optimizer="cmaes", nm=NM,
                   device=CPU)


@pytest.fixture(scope="module")
def port_kernel():
    return twl.run(ttk.TokamakConfig(**SPLIT), optimizer="cmaes", nm=NM,
                   backend="kernel", with_reference=False, device=CPU)


def test_split_generic_matches_jax(port_generic, jax_generic):
    """Gates of test_tokamak_split, then the JAX run: hyperparameters at
    1e-4, float64 trajectories at 1e-5, metrics at 1e-4 relative."""
    t, j = port_generic, jax_generic
    assert t["training_error"] < 1e-10
    assert np.nanmean(t["gd"]) < 1e-2
    assert t["traj"].q.shape == (NM, 30)
    assert t["traj"].q.dtype == torch.float64
    assert len(t["hyps"]) == 4 and len(t["nfev_sympl"]) == 4
    for a, b in zip(t["hyps"] + [t["sigs"]], j["hyps"] + [j["sigs"]]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4)
    assert t["n_lost"] == j["n_lost"]
    np.testing.assert_allclose(npy(t["traj"].q), np.asarray(j["traj"].q),
                               atol=1e-5)
    np.testing.assert_allclose(npy(t["traj"].p), np.asarray(j["traj"].p),
                               atol=1e-5)
    assert t["Eosc"].shape == (30,)  # one section point a turn
    np.testing.assert_allclose(t["Eosc"], j["Eosc"], rtol=1e-4)
    np.testing.assert_allclose(t["gd"], j["gd"], rtol=1e-4, atol=1e-12)
    assert t["ref_sections"].shape == j["ref_sections"].shape == (
        NM // 4 + 1, 30, 3)
    np.testing.assert_allclose(t["ref_sections"], j["ref_sections"],
                               rtol=1e-10, atol=1e-12)


def test_split_kernel_matches_jax_pallas(port_kernel, jax_pallas):
    """Gate of test_tokamak_split_pallas_backend, then the JAX run: float32
    steps 1-2 at 1e-4, lost orbits equal, mean Eosc at 1e-3 relative."""
    t, j = port_kernel, jax_pallas
    (r0, th0), _ = ttk.test_initial_conditions(ttk.TokamakConfig(**SPLIT))
    gd = twl.one_turn_gd(ttk.TokamakConfig(**SPLIT), t["traj"], r0, th0,
                         CPU)["gd"]
    assert np.nanmedian(gd) < 2e-2
    assert t["traj"].q.dtype == torch.float32 and t["backend"] == "kernel"
    for i in (1, 2):
        np.testing.assert_allclose(npy(t["traj"].q[i]),
                                   np.asarray(j["traj"].q[i]), atol=1e-4)
        np.testing.assert_allclose(npy(t["traj"].p[i]),
                                   np.asarray(j["traj"].p[i]), atol=1e-4)
    assert t["n_lost"] == j["n_lost"]
    np.testing.assert_allclose(np.nanmean(t["Eosc"]), np.nanmean(j["Eosc"]),
                               rtol=1e-3)
