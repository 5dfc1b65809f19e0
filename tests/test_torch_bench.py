"""The port's headline benchmark (``sympgpr_tpu_torch/bench.py``, ``python
-m sympgpr_tpu_torch bench``) on the CPU at small sizes, against the JAX
package's root ``bench.py``: the same stages, the detail's keys, the
headline last, and the N = 80 fit and its float64 reference-size run on
the same data as JAX's ``_fit_one_split`` and ``apply_map``.

The two L-BFGS runs stop a few 1e-7 apart (``test_torch_likelihood.py::
test_fits_match_jax``): hyperparameters at rtol 1e-4, the NLL at the
optimum at 1e-8, the float64 trajectory at 1e-5 and its mean Eosc at 1e-4
relative (``test_torch_workload.py``).
"""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, npy  # noqa: E402

from sympgpr_tpu.eval import metrics as jmet  # noqa: E402
from sympgpr_tpu.gp import likelihood as jlik  # noqa: E402
from sympgpr_tpu.maps import symplectic as jsm  # noqa: E402
from sympgpr_tpu.systems import tokamak as jtk  # noqa: E402
from sympgpr_tpu.workloads import tokamak as jwl  # noqa: E402
from sympgpr_tpu_torch import __main__ as cli  # noqa: E402
from sympgpr_tpu_torch import bench  # noqa: E402
from sympgpr_tpu_torch.gp import likelihood as tlik  # noqa: E402
from sympgpr_tpu_torch.systems import tokamak as ttk  # noqa: E402

# the detail's keys, written out from the JAX package's bench.py:333-352
JAX_DETAIL_KEYS = [
    "device", "dtype", "fit_s", "cpu_baseline_steps_per_s",
    "ref_size_steps_per_s", "ref_size_speedup", "lost_orbits_10k",
    "rollout_mxu_reduce_steps_per_s", "large_n", "tokamak_large",
    "nuts_samples_per_s", "nuts_context", "compile_cache_dir",
    "total_bench_s"]
NM = 20  # the reference-size run's steps here (10,000 in the benchmark)


def test_main_on_the_cpu_prints_detail_then_headline(capsys):
    """The whole module on the CPU (the JAX file's branch off the TPU):
    N = 80 fit, 5 baseline steps, 30 x 20 and 32 x 10 float64 rollouts.
    The detail carries the JAX file's keys, the MXU experiment's null and
    no large-N or NUTS stage; the headline is the last line and its
    vs_baseline is value / cpu_baseline_steps_per_s to their rounding."""
    head = bench.main(CPU, nm_base=5, ref_steps=NM, batch=32, batch_steps=10)
    out, err = capsys.readouterr()
    lines = [json.loads(ln) for ln in out.strip().splitlines()]
    assert lines[-1] == head and len(lines) == 2
    assert list(head) == ["metric", "value", "unit", "vs_baseline"]
    assert head["metric"] == "tokamak_rollout_orbit_steps_per_s"
    assert head["unit"] == "orbit-steps/s" and head["value"] > 0
    d = lines[0]["detail"]
    assert list(d) == JAX_DETAIL_KEYS
    assert d["dtype"] == "float64" and d["device"] == "cpu"
    for k in ("rollout_mxu_reduce_steps_per_s", "large_n", "tokamak_large",
              "nuts_samples_per_s", "nuts_context"):
        assert d[k] is None, k
    base = d["cpu_baseline_steps_per_s"]
    assert base > 0 and d["fit_s"] > 0 and d["ref_size_steps_per_s"] > 0
    # value and baseline are rounded to 0.1, vs_baseline to 0.01
    slack = 0.005 + 0.05 * (1 / base + head["value"] / base**2)
    assert abs(head["vs_baseline"] - head["value"] / base) <= slack
    assert abs(d["ref_size_speedup"]
               - d["ref_size_steps_per_s"] / base) <= 0.005 + 0.05 * (
        1 / base + d["ref_size_steps_per_s"] / base**2)
    assert 0 <= d["lost_orbits_10k"] <= 30
    diag = json.loads(err.strip().splitlines()[-1])
    assert diag["launches"]["rollout"] == 0  # CPU tensors: no kernel
    assert np.isfinite(diag["ref_size_mean_Eosc"])


@pytest.fixture(scope="module")
def fits():
    """The N = 80 fits of both packages on the same data (float64)."""
    jcfg = jtk.TokamakConfig()
    d = jtk.training_data(jcfg)
    aux_j, sgp_j, _ = jwl._fit_one_split(d["q"][:, 0], d["p"][:, 0],
                                         d["Q"][:, 0], d["P"][:, 0], jcfg,
                                         "lbfgs")
    aux_t, sgp_t, t_fit = bench.fit(ttk.TokamakConfig(), CPU)
    return jcfg, aux_j, sgp_j, aux_t, sgp_t, t_fit


def test_fit_matches_jax(fits):
    jcfg, aux_j, sgp_j, aux_t, sgp_t, t_fit = fits
    assert t_fit > 0 and sgp_t.params.dtype == torch.float64
    assert sgp_t.n_train == 80
    np.testing.assert_allclose(npy(sgp_t.params), np.asarray(sgp_j.params),
                               rtol=1e-4)
    np.testing.assert_allclose(float(sgp_t.sig), float(sgp_j.sig), rtol=1e-4)
    np.testing.assert_allclose(npy(aux_t.params), np.asarray(aux_j.params),
                               rtol=1e-4)
    nll_t = tlik.nll(sgp_t.kernel, sgp_t.params, sgp_t.sig, sgp_t.sig2n,
                     sgp_t.X, sgp_t.z)
    nll_j = jlik.nll(sgp_j.kernel, sgp_j.params, sgp_j.sig, sgp_j.sig2n,
                     sgp_j.X, sgp_j.z)
    np.testing.assert_allclose(float(nll_t), float(nll_j), rtol=1e-8)


def test_reference_size_run_matches_jax(fits):
    """The CPU branch's reference-size run: float64 fast path, Newton to
    1e-12 in at most 8 iterations, the loss at the old q, against JAX's
    ``apply_map`` with the JAX bench's configuration; its mean Eosc as
    the JAX bench computes it (``energy_oscillation(H, axis=0)``)."""
    jcfg, aux_j, sgp_j, aux_t, sgp_t, _ = fits
    tcfg = ttk.TokamakConfig()
    q0, p0 = bench.initial_conditions(tcfg, CPU)
    ref, (Q, P), big = bench.cpu_rollouts(sgp_t, aux_t, q0, p0, tcfg,
                                          ref_steps=NM, batch=32,
                                          batch_steps=5)
    assert ref > 0 and big > 0 and Q.shape == (NM, 30)
    (r0, th0), _ = jtk.test_initial_conditions(jcfg)
    pth0, _ = jtk.ics_to_pth(r0, th0)
    np.testing.assert_allclose(npy(p0), np.asarray(pth0) * float(
        jcfg.momentum_scale), rtol=1e-12)
    traj = jsm.apply_map(sgp_j, aux_j, jnp.asarray(th0),
                         jnp.asarray(pth0) * float(jcfg.momentum_scale), NM,
                         jsm.MapConfig(newton_tol=1e-12, newton_maxiter=8),
                         loss_pre=jwl.make_loss_fn(jcfg, use_new_q=False))
    np.testing.assert_allclose(npy(Q), np.asarray(traj.q), atol=1e-5)
    np.testing.assert_allclose(npy(P), np.asarray(traj.p), atol=1e-5)
    H = jax.vmap(lambda q, p: jtk.field_energy(jcfg.field, q, p))(
        traj.q, traj.p)
    eosc_j = float(jnp.nanmean(jmet.energy_oscillation(H, axis=0)))
    np.testing.assert_allclose(bench.mean_eosc(tcfg, Q, P), eosc_j,
                               rtol=1e-4)


def test_card_stages_run_on_cpu_tensors(fits):
    """The card's stages on CPU tensors at small sizes (the rollout's
    plain version, NUTS in float32): finite rates, the rollout's float32
    (Q, P) of the reference size, NUTS's context."""
    _, _, _, aux_t, sgp_t, _ = fits
    q0, p0 = bench.initial_conditions(ttk.TokamakConfig(), CPU)
    ref, (Q, P), big = bench.kernel_rollouts(sgp_t, aux_t, q0, p0,
                                             ref_steps=10, batch=64,
                                             batch_steps=4)
    assert ref > 0 and big > 0
    assert Q.shape == (10, 30) and Q.dtype == torch.float32
    sps, ctx = bench.nuts_samples_per_s(sgp_t, CPU, chains=2, draws=2,
                                        warmup=2, max_depth=2)
    assert sps > 0
    assert ctx == {"N_train": 80, "chains": 2, "draws": 2, "warmup": 2,
                   "max_depth": 2}


def test_cuda_without_a_card_exits():
    """``--device cuda`` on a machine without CUDA exits non-zero with a
    message, and ``run`` raises: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--device", "cuda"])
    assert e.value.code not in (0, None) and "cuda" in str(e.value.code)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run("cuda")
