"""``native.py`` of the port: the same C++ sources and flags as the JAX
package's bindings give the same numbers, and the native integrators agree
with the port's own PyTorch integrators within ``tests/test_native.py``'s
tolerances."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, npy, t64  # noqa: E402

from sympgpr_tpu_torch import native  # noqa: E402
from sympgpr_tpu_torch.systems import henon_heiles as hh  # noqa: E402
from sympgpr_tpu_torch.systems import tokamak as tk  # noqa: E402


@pytest.fixture(scope="module")
def lib():
    """Both packages' libraries, built on first use; skips without g++ or
    make."""
    from sympgpr_tpu import native as jnative

    if not (native.available() and jnative.available()):
        pytest.skip("native toolchain unavailable")
    return jnative


def _tokamak_ics(npart, seed):
    cfg = tk.TokamakConfig()
    rng = np.random.default_rng(seed)
    r0 = rng.uniform(0.12, 0.3, npart)
    th0 = rng.uniform(0, 2 * np.pi, npart)
    pth0 = npy(tk.Ath(t64(r0), t64(th0), 0.0))
    return cfg, r0, th0, np.stack([pth0, th0, np.zeros(npart)], axis=1)


def test_library_is_built_into_the_port(lib):
    path = native.build()
    assert path.endswith("sympgpr_tpu_torch/_build/libsympgpr_native.so")
    assert native.available()


def test_ath_and_compute_r_are_jax(lib):
    for r, th in ((0.22, 1.3), (0.2, 0.7), (0.41, 5.9)):
        assert native._lib().sympgpr_ath(r, th) == lib._lib().sympgpr_ath(
            r, th)
        pth = float(tk.Ath(t64(r), t64(th), 0.0))
        assert native.compute_r(pth, th) == lib.compute_r(pth, th)
        assert native.compute_r(pth, th) == pytest.approx(r, rel=1e-12)
    np.testing.assert_allclose(native._lib().sympgpr_ath(0.2, 0.7),
                               float(tk.Ath(t64(0.2), t64(0.7), 0.0)),
                               rtol=1e-14)


def test_fieldlines_are_jax_and_the_port_integrator(lib):
    cfg, r0, th0, z0 = _tokamak_ics(4, 0)
    nsteps = 2 * cfg.nph  # two turns
    args = (cfg.eps, cfg.mod_m, cfg.mod_n, 0.0, cfg.nph, nsteps, z0, r0)
    out = native.fieldlines_integrate(*args)
    np.testing.assert_array_equal(out, lib.fieldlines_integrate(*args))
    ref = tk.integrate_fieldlines(cfg.field, t64(z0[:, 0]), t64(th0),
                                  torch.zeros(4, dtype=torch.float64),
                                  cfg.nph, nsteps, t64(r0))
    # both solve the same midpoint residual to ~1e-13; over two turns the
    # Newton variants, not chaos, set the agreement
    np.testing.assert_allclose(out, npy(ref), atol=1e-8)


def test_henon_sections_are_jax_and_the_port_integrator(lib):
    cfg = hh.HenonConfig(N=6)
    z0 = hh.training_ics(cfg)[:6]
    got = native.henon_sections(z0, 2, lam=cfg.lam, dt=cfg.dt)
    want = lib.henon_sections(z0, 2, lam=cfg.lam, dt=cfg.dt)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    cuts, tcuts, counts = hh.integrate_sections(
        cfg, torch.as_tensor(z0, device=CPU), int(4 * 7.5 / cfg.dt), 2)
    np.testing.assert_array_equal(got[2], npy(counts))
    np.testing.assert_allclose(got[0], npy(cuts), atol=1e-9)
    np.testing.assert_allclose(got[1], npy(tcuts), atol=1e-9)


def test_shapes_are_checked(lib):
    with pytest.raises(ValueError):
        native.fieldlines_integrate(1e-3, -3, 2, 0.0, 32, 2, np.zeros((4, 2)),
                                    np.zeros(4))
    with pytest.raises(ValueError):
        native.henon_sections(np.zeros((3, 3)), 2)
