"""The port's copy of the numpy/scipy CPU baseline
(``baselines/reference_cpu.py``): exactly the JAX package's module on the
same inputs, and in agreement with the port's own covariance builders and
map (``tests/test_reference_equivalence.py``'s cases and tolerances)."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402
from torch_parity import npy, t64  # noqa: E402

from sympgpr_tpu.baselines import reference_cpu as jref  # noqa: E402
from sympgpr_tpu_torch.baselines import reference_cpu as ref  # noqa: E402
from sympgpr_tpu_torch.gp.covariance import build_K, build_Kreg  # noqa: E402
from sympgpr_tpu_torch.gp.model import AuxGP, SympGP  # noqa: E402
from sympgpr_tpu_torch.kernels import PER_SE  # noqa: E402
from sympgpr_tpu_torch.maps.symplectic import MapConfig, apply_map  # noqa: E402,E501

Q0 = np.array([0.4, 1.7, 3.0, 5.2])
P0 = np.array([0.1, -0.3, 0.5, 0.0])


def _setup(mod, n=12, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 2 * np.pi, n)
    P = rng.uniform(-1, 1, n)
    X = np.stack([q, P], 1)
    z = np.concatenate([0.3 * np.sin(q) * P, 0.2 * np.cos(q)])
    p = rng.uniform(-1, 1, n)
    Xp = np.stack([q, p], 1)
    zp = 0.3 * np.sin(q) * p
    return mod.ReferenceStyleModel(X, z, 0.9, 1.2, 1.7, 1e-10, Xp, zp,
                                   1.0, 1.1, 1.3, aux_delta=True)


def test_builders_and_predictors_are_jax():
    m, jm = _setup(ref), _setup(jref)
    np.testing.assert_array_equal(ref.build_K(m.X, m.X, m.lx, m.ly, m.sig),
                                  jref.build_K(m.X, m.X, m.lx, m.ly, m.sig))
    np.testing.assert_array_equal(
        ref.build_Kreg(m.Xp, m.Xp, m.lxp, m.lyp, m.sigp),
        jref.build_Kreg(m.Xp, m.Xp, m.lxp, m.lyp, m.sigp))
    np.testing.assert_array_equal(m.Kyinv, jm.Kyinv)
    for q, P in [(0.5, 0.2), (2.5, -0.6), (5.0, 0.9)]:
        assert ref._dF(m, q, P) == jref._dF(jm, q, P)
        assert ref.guessP(m, q, P) == jref.guessP(jm, q, P)
        assert ref.calcP(m, q, P) == jref.calcP(jm, q, P)


def test_applymap_and_loss_are_jax():
    m, jm = _setup(ref), _setup(jref)
    loss, jloss = ref.tokamak_loss_fn(), jref.tokamak_loss_fn()
    for a, b in zip(ref.applymap(m, 5, Q0, P0, loss_fn=loss),
                    jref.applymap(jm, 5, Q0, P0, loss_fn=jloss)):
        np.testing.assert_array_equal(a, b)
    for q, P in [(0.3, 0.5), (1.0, -0.1), (2.0, 30.0)]:
        assert loss(q, P) == jloss(q, P)


def test_agrees_with_the_port():
    """The builders at 1e-12 and a 5-step rollout at 1e-7 against the
    port's ``build_K`` / ``build_Kreg`` and ``apply_map`` in float64."""
    m = _setup(ref)
    sgp = SympGP.create(PER_SE, t64([m.lx, m.ly]), t64(m.sig), t64(1e-10),
                        t64(m.X), t64(m.z))
    aux = AuxGP.create(PER_SE, t64([m.lxp, m.lyp]), t64(m.sigp), t64(1e-10),
                       t64(m.Xp), t64(m.zp), delta=True)
    np.testing.assert_allclose(
        npy(build_K(PER_SE, sgp.X, sgp.X, sgp.params, sgp.sig)),
        ref.build_K(m.X, m.X, m.lx, m.ly, m.sig), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(
        npy(build_Kreg(PER_SE, aux.X, aux.X, aux.params, aux.sig)),
        ref.build_Kreg(m.Xp, m.Xp, m.lxp, m.lyp, m.sigp), rtol=1e-12,
        atol=1e-13)
    q_np, p_np = ref.applymap(m, 5, Q0, P0)
    traj = apply_map(sgp, aux, t64(Q0), t64(P0), 5,
                     MapConfig(newton_tol=1e-13, newton_maxiter=50))
    np.testing.assert_allclose(npy(traj.q), q_np, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(npy(traj.p), p_np, rtol=1e-7, atol=1e-8)
