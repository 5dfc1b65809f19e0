"""``workloads/large_n.py`` against the JAX package's on the CPU: the
synthetic training set and the sweep's models exactly, one sweep instance's
plain rollout against JAX's rollout kernel in interpret mode, and
``measure`` in float64 (its key set, and the Adam run's NLLs)."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, npy  # noqa: E402

from sympgpr_tpu_torch.gp.likelihood import nll_value_and_grad_theta  # noqa: E402,E501
from sympgpr_tpu_torch.kernels import PER_SE  # noqa: E402
from sympgpr_tpu_torch.ops import cuda_step  # noqa: E402
from sympgpr_tpu_torch.workloads import large_n  # noqa: E402

RTOL_NLL = 1e-9       # measure's Adam NLLs, port against JAX, float64
RTOL_GRAD = 1e-10     # the closed-form gradient against autodiff, float64
ATOL_ROLLOUT = 1e-4   # float32 rollout, steps 1-2, port against JAX
LANE_TILE = 128       # the JAX kernel's batch granularity


def _jax_sweep_models(Ns, B):
    """The JAX package's sweep models, drawn as its ``rollout_sweep``
    draws them (sympgpr_tpu/workloads/large_n.py)."""
    from sympgpr_tpu.ops import pallas_step as psk

    rng = np.random.default_rng(0)
    out = []
    for N in Ns:
        ns, nas = psk._pad8(N), psk._pad8(64)

        def col(v):
            return jnp.asarray(np.asarray(v, np.float32).reshape(-1, 1))

        scal = np.zeros((1, psk.NSCAL), np.float32)
        scal[0, :6] = [0.6, 0.6, 0.6, 0.6, 1.0, 2 * np.pi]
        pm = psk.PackedModels(
            uq=col(rng.uniform(0, 2 * np.pi, ns)),
            uP=col(rng.uniform(-1, 1, ns)),
            a0=col(rng.normal(size=ns) / ns),
            a1=col(rng.normal(size=ns) / ns),
            auxq=col(rng.uniform(0, 2 * np.pi, nas)),
            auxp=col(rng.uniform(-1, 1, nas)),
            auxa=col(rng.normal(size=nas) / nas),
            scal=jnp.asarray(scal),
            kind=0, aux_kind=0, n_maps=1, ns=ns, nas=nas)
        q0 = jnp.asarray(rng.uniform(0, 2 * np.pi, B), jnp.float32)
        p0 = jnp.asarray(rng.uniform(-1, 1, B), jnp.float32)
        out.append((pm, q0, p0))
    return out


@pytest.mark.parametrize("N", [1, 50, 257])
def test_synthetic_training_set_is_jax(N):
    from sympgpr_tpu.workloads import large_n as jl

    Xj, zj = jl.synthetic_training_set(N, jnp.float64)
    X, z = large_n.synthetic_training_set(N, torch.float64, device=CPU)
    np.testing.assert_array_equal(npy(X), np.asarray(Xj))
    np.testing.assert_array_equal(npy(z), np.asarray(zj))
    X32, _ = large_n.synthetic_training_set(N, device=CPU)
    assert X32.dtype == torch.float32


def test_sweep_models_are_jax():
    Ns, B = (16, 40, 512), 8
    ports = list(large_n.sweep_instances(Ns, B, CPU))
    for (N, pm, q0, p0), (jpm, jq0, jp0) in zip(ports,
                                               _jax_sweep_models(Ns, B)):
        assert (pm.ns, pm.nas, pm.kind, pm.aux_kind, pm.n_maps) == (
            jpm.ns, jpm.nas, 0, 0, 1)
        for f in ("uq", "uP", "a0", "a1", "auxq", "auxp", "auxa"):
            np.testing.assert_array_equal(npy(getattr(pm, f)),
                                          np.asarray(getattr(jpm, f))[:, 0])
        np.testing.assert_array_equal(npy(pm.scal), np.asarray(jpm.scal))
        np.testing.assert_array_equal(npy(q0), np.asarray(jq0))
        np.testing.assert_array_equal(npy(p0), np.asarray(jp0))
        assert pm.delta and pm.mod_q == 2 * np.pi and pm.mod_p is None


def test_sweep_instance_rolls_out_as_jax_interpret():
    """N=16, B=8, nm=4: the port's rollout (its plain version on the CPU)
    against JAX's rollout kernel in interpret mode on the same packed
    columns (its batch padded to one lane tile), steps 1-2."""
    from sympgpr_tpu.ops import pallas_step as psk

    _, pm, q0, p0 = next(large_n.sweep_instances((16,), 8, CPU))
    Q, P = cuda_step.rollout_in_kernel(pm, q0, p0, 4)
    jpm, jq0, jp0 = _jax_sweep_models((16,), 8)[0]
    reps = LANE_TILE // 8
    Qj, Pj = psk.rollout_in_kernel(jpm, jnp.tile(jq0, reps),
                                   jnp.tile(jp0, reps), 4, interpret=True)
    Qj, Pj = np.asarray(Qj)[:, :8], np.asarray(Pj)[:, :8]
    assert Q.shape == (4, 8) and np.isfinite(npy(P)).all()
    for i in (1, 2):
        np.testing.assert_allclose(npy(P[i]), Pj[i], atol=ATOL_ROLLOUT)
        np.testing.assert_allclose(npy(Q[i]), Qj[i], atol=ATOL_ROLLOUT)


def test_rollout_sweep_on_cpu():
    out = large_n.rollout_sweep(Ns=(16,), B=8, nm=3, device=CPU)
    assert set(out) == {"B", "nm", "N16_ms", "N16_steps_per_s",
                        "N16_pair_gsteps_per_s"}
    assert out["N16_steps_per_s"] == pytest.approx(2 * 8 / (
        out["N16_ms"] * 1e-3))


def test_measure_float64_is_jax():
    """The same key set as JAX's CPU run, and the Adam run's first and last
    NLL within 1e-9 of JAX's (float64, N=32, 3 steps)."""
    from sympgpr_tpu.workloads import large_n as jl

    want = jl.measure(N=32, reps=2, dtype=jnp.float64, train_steps=3)
    got = large_n.measure(N=32, reps=2, dtype=torch.float64, train_steps=3,
                          device=CPU)
    assert set(got) == set(want)
    for k in ("N", "n", "dtype", "nll_decreased"):
        assert got[k] == want[k], k
    for k in ("nll_first", "nll_last"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_NLL)
    assert got["nll_decreased"]
    for k, v in got.items():
        if k.endswith("_s") and k != "adam_compile_s":
            assert np.isfinite(v) and v > 0, k


def test_closed_form_gradient_is_autodiff_float64():
    X, z = large_n.synthetic_training_set(40, torch.float64, device=CPU)
    th = large_n.theta0(torch.float64, CPU)
    s2n = torch.tensor(1e-2, dtype=torch.float64)
    v_cf, g_cf = nll_value_and_grad_theta(PER_SE, th, s2n, X, z)
    v_ad, g_ad = large_n.nll_value_and_grad_autodiff(th, s2n, X, z)
    np.testing.assert_allclose(float(v_cf), float(v_ad), rtol=1e-12)
    assert float((g_cf - g_ad).norm() / g_ad.norm()) <= RTOL_GRAD


def test_check_gradients_float32_on_cpu():
    """The float32 gradients against float64, with the card's rule, on the
    plain versions."""
    res = large_n.check_gradients(32, device=CPU)
    assert res["ok"], res
    assert len(res["grad_f64"]) == 3
    assert res["err_closed_form"] < 1e-4 and res["err_autodiff"] < 1e-4
    assert res["err_between_paths"] < 1e-4


def test_sweep_check_on_cpu():
    """On CPU tensors the rollout is its plain version: no difference,
    and the float32 plain version near float64."""
    _, pm, q0, p0 = next(large_n.sweep_instances((40,), 64, CPU))
    res = large_n.sweep_check(pm, q0, p0, orbits=32, steps=2)
    assert res["ok"] and res["max_abs_err_steps_1_2"] == 0.0
    assert res["nan_pattern_equal"]
    assert 0 < res["err_plain"] < 1e-5
    assert res["err_kernel"] == res["err_plain"]


def test_deployment_instance_on_cpu():
    """measure's deployment rollout, rebuilt from a theta: the trained
    model's pack without an aux model, ROLLOUT_B orbits, held by
    ``sweep_check`` (the plain version on CPU tensors)."""
    X, z = large_n.synthetic_training_set(24, device=CPU)
    theta = large_n.theta0(torch.float32, CPU)
    pm, q0, p0 = large_n.deployment_instance(
        theta, X, z, torch.tensor(1e-2))
    assert pm.ns == 24 and pm.a0.dtype == torch.float32
    assert q0.shape == p0.shape == (large_n.ROLLOUT_B,)
    res = large_n.sweep_check(pm, q0, p0, orbits=32, steps=2)
    assert res["ok"] and res["max_abs_err_steps_1_2"] == 0.0, res
    assert 0 < res["err_plain"] < 1e-4
