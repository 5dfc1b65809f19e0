"""PyTorch port vs JAX: the Saltelli design, Sobol indices, and the
tokamak chaos QoI (a batched field-line integration with eps and phase per
row) with its Newton Jacobian through ``compute_r``."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, npy, t64  # noqa: E402

from sympgpr_tpu import sensitivity as jsens  # noqa: E402
from sympgpr_tpu_torch import sensitivity as tsens  # noqa: E402
from sympgpr_tpu_torch.systems import tokamak as ttk  # noqa: E402

BOUNDS = [(0.0, 0.004), (0.0, 2 * np.pi)]


@pytest.mark.parametrize("n, bounds", [(8, BOUNDS),
                                       (16, [(0, 1), (-1, 2), (3, 4)])])
def test_saltelli_sample_equals_jax(n, bounds):
    np.testing.assert_array_equal(tsens.saltelli_sample(n, bounds, seed=3),
                                  jsens.saltelli_sample(n, bounds, seed=3))


def test_sobol_indices_additive_model():
    """f = 3 x0 + x1 on the unit square: S1 = ST = (0.9, 0.1) within the
    JAX test's 0.05, and equal to JAX's estimates at 1e-12."""
    S1, ST, var = tsens.sobol_indices(lambda t: 3.0 * t[:, 0] + t[:, 1],
                                      [(0, 1), (0, 1)], n=512, device=CPU)
    expect = np.array([9.0, 1.0]) / 10.0
    np.testing.assert_allclose(S1, expect, atol=0.05)
    np.testing.assert_allclose(ST, expect, atol=0.05)
    S1j, STj, varj = jsens.sobol_indices(lambda t: 3.0 * t[0] + 1.0 * t[1],
                                         [(0, 1), (0, 1)], n=512)
    np.testing.assert_allclose(S1, S1j, rtol=1e-12)
    np.testing.assert_allclose(ST, STj, rtol=1e-12)
    np.testing.assert_allclose(var, varj, rtol=1e-12)


def test_tokamak_chaos_qoi_matches_jax():
    """8 (eps, phase) rows, 2 turns of 32 steps, at 1e-10."""
    rng = np.random.default_rng(0)
    theta = np.stack([rng.uniform(0, 0.004, 8),
                      rng.uniform(0, 2 * np.pi, 8)], 1)
    want = np.asarray(jax.jit(jax.vmap(jsens.tokamak_chaos_qoi(
        n_turns=2, nph=32)))(jnp.asarray(theta)))
    got = npy(tsens.tokamak_chaos_qoi(n_turns=2, nph=32)(t64(theta)))
    assert np.all(np.isfinite(got)) and np.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_newton_jacobian_with_a_field_per_row_is_jacfwd():
    """The QoI's Newton step takes ``_tstep_jacobian`` of a field whose eps
    and phase are (B,) tensors: it is the Jacobian of the residual through
    ``compute_r``'s 20 iterations, as ``torch.func.jacfwd`` (JAX's
    ``jacfwd``) differentiates it, at 1e-12."""
    rng = np.random.default_rng(1)
    B = 6
    eps = t64(rng.uniform(0, 0.004, B))
    phase = t64(rng.uniform(0, 2 * np.pi, B))
    field = ttk.TokamakField(eps=eps, phase=phase)
    dph = 2 * np.pi / 32
    r0 = t64(rng.uniform(0.15, 0.3, B))
    th = t64(rng.uniform(0, 2 * np.pi, B))
    z = torch.stack([ttk.Ath(r0, th, 0.0), th, t64(rng.uniform(0, 6, B))],
                    -1)
    znew = z[:, :2] + t64(rng.normal(0, 1e-3, (B, 2)))
    _, r = ttk._tstep_residual(field, dph, znew, z, r0)
    J = ttk._tstep_jacobian(field, dph, znew, z, r)

    def res_one(zn, zo, rl, e, ph):
        f = ttk.TokamakField(eps=e, phase=ph)
        return ttk._tstep_residual(f, dph, zn[None], zo[None], rl[None])[0][0]

    Jf = torch.func.vmap(torch.func.jacfwd(res_one))(znew, z, r0, eps,
                                                     phase)
    np.testing.assert_allclose(npy(J), npy(Jf), rtol=1e-12, atol=1e-15)


def test_sobol_indices_of_the_tokamak_qoi_match_jax():
    """S1, ST and var over (eps, phase) at n = 8, 2 turns (32 QoI rows)."""
    S1j, STj, varj = jsens.sobol_indices(
        jsens.tokamak_chaos_qoi(n_turns=2), BOUNDS, n=8)
    S1, ST, var = tsens.sobol_indices(tsens.tokamak_chaos_qoi(n_turns=2),
                                      BOUNDS, n=8, device=CPU)
    assert np.all(np.isfinite(S1)) and np.all(np.isfinite(ST))
    np.testing.assert_allclose(S1, S1j, rtol=1e-9)
    np.testing.assert_allclose(ST, STj, rtol=1e-9)
    np.testing.assert_allclose(var, varj, rtol=1e-9)
