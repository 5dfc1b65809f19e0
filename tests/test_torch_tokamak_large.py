"""PyTorch port vs JAX: the large-N tokamak slice end to end
(``workloads/tokamak_large.py``) at the reduced arguments of
``tests/test_workloads.py::test_tokamak_large_end_to_end``, float64 fit,
float32 rollout, on the same inputs in both packages.

The fit is float64 arithmetic on identical data: history, hyperparameters
and train_mse at rtol 1e-8.  The rollout is float32 in both packages with
|alpha| up to ~7e2 (sig2n 1e-4): each float32 rollout is within ~2e-3 of
the float64 rollout of the same model at step 1 (measured, CPU), and the
two differ by ~1.5e-3 there.  So the rollout metrics are held as float32
statistics: mean Eosc at rtol 1e-2 (measured 2.4e-3) and gd, a squared
distance of ~8e-3 that a 2e-3 shift moves by tens of percent, at rtol 0.1
(measured 2.4e-2), with the same lost set.  Both runs also roll the
fitted models out in float64 (``with_f64_rollout``): mean Eosc at rtol
RTOL_EOSC_F64 and the same lost count.
"""

import json
import math

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, jax_models_to_port, npy, toy_data  # noqa: E402

from sympgpr_tpu.gp import model as jm  # noqa: E402
from sympgpr_tpu.gp.covariance import build_K as jbuild_K  # noqa: E402
from sympgpr_tpu.kernels import PER_SE as JPER_SE  # noqa: E402
from sympgpr_tpu.ops import pallas_step as psk  # noqa: E402
from sympgpr_tpu.workloads import tokamak_large as jwl  # noqa: E402
from sympgpr_tpu_torch import __main__ as cli  # noqa: E402
from sympgpr_tpu_torch.ops import cuda_step  # noqa: E402
from sympgpr_tpu_torch.workloads import tokamak_large as twl  # noqa: E402

ARGS = dict(n_train=160, nm=12, steps=25, aux_subsample=80, sig2n=1e-4,
            with_f64_rollout=True)
# float64 rollouts of models that agree at ~1e-11 (the fits' float64
# arithmetic in another order): mean Eosc measured 7.0e-12 apart
RTOL_EOSC_F64 = 1e-9


@pytest.fixture(scope="module")
def jax_run():
    """JAX ``run`` returns no NLL history: it is taken from the fit the
    run makes, through a wrapper of the module's ``fit_sympgp_large``."""
    fit, hists = jwl.fit_sympgp_large, []

    def recording_fit(*args, **kw):
        result = fit(*args, **kw)
        hists.append(np.asarray(result[1]))
        return result

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwl, "fit_sympgp_large", recording_fit)
        out = jwl.run(**ARGS)
    (out["hist"],) = hists
    return out


@pytest.fixture(scope="module")
def port_run():
    return twl.run(**ARGS, device=CPU)


def test_gates(port_run):
    out = port_run
    assert out["nll_decreased"], (out["nll_first"], out["nll_last"])
    assert np.isfinite(out["mean_Eosc"])
    assert out["n_lost"] == 0
    assert out["train_mse"] < 1e-2, out["train_mse"]
    assert np.isfinite(out["gd"])
    assert out["dtype"] == "float64" and out["N"] == 160
    assert out["jitter_escalations"] == 0
    assert len(out["hist"]) == 25 and np.all(np.isfinite(out["hist"]))
    assert out["hist"][0] == out["nll_first"]
    sgp, aux = out["models"]
    assert sgp.alpha.shape == (320,) and aux.X.shape == (80, 2)


def test_fit_matches_jax(port_run, jax_run):
    t, j = port_run, jax_run
    assert len(t["hist"]) == len(j["hist"]) == ARGS["steps"]
    np.testing.assert_allclose(t["hist"], j["hist"], rtol=1e-8)
    for k in ("nll_first", "nll_last", "train_mse"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-8, err_msg=k)
    np.testing.assert_allclose(t["hyp"], j["hyp"], rtol=1e-8)
    assert t["sig2n_used"] == j["sig2n_used"]


def test_rollout_metrics_match_jax(port_run, jax_run):
    t, j = port_run, jax_run
    assert t["n_lost"] == j["n_lost"]
    np.testing.assert_allclose(t["mean_Eosc"], j["mean_Eosc"], rtol=1e-2)
    np.testing.assert_allclose(t["gd"], j["gd"], rtol=0.1)


def test_jax_model_rolls_out_in_port():
    """Weights across: a JAX ``SympGP.from_alpha`` model (alpha solved at
    jitter 1e-2, |alpha| ~ 1e1) rolls out in both packages; float32 steps
    1-2 at 2e-5, as tests/test_pallas_step.py (measured: 6.4e-6, and each
    float32 rollout is within 7e-6 of the float64 one)."""
    X, z, Xp, zp = toy_data(40, seed=2)
    params, sig = jnp.asarray([0.9, 1.2]), jnp.asarray(1.5)
    K = np.asarray(jbuild_K(JPER_SE, jnp.asarray(X), jnp.asarray(X), params,
                            sig))
    alpha = np.linalg.solve(K + 1e-2 * np.eye(80), z)
    sgp_j = jm.SympGP.from_alpha(JPER_SE, params, sig, jnp.asarray(1e-2),
                                 jnp.asarray(X), jnp.asarray(z),
                                 jnp.asarray(alpha))
    aux_j = jm.AuxGP.create(JPER_SE, params, sig, 1e-3, jnp.asarray(Xp),
                            jnp.asarray(zp))
    sgp_t, aux_t = jax_models_to_port(sgp_j, aux_j)
    assert sgp_t.L.shape == (0, 0)
    rng = np.random.default_rng(3)
    q0, p0 = rng.uniform(0, 2 * np.pi, 64), rng.uniform(-0.5, 0.5, 64)
    Qj, Pj = psk.rollout_pallas(sgp_j, aux_j, jnp.asarray(q0),
                                jnp.asarray(p0), 3, deployment_jitter=None)
    Qt, Pt = cuda_step.rollout_model(sgp_t, aux_t, torch.tensor(q0),
                                     torch.tensor(p0), 3,
                                     deployment_jitter=None)
    for i in (1, 2):
        np.testing.assert_allclose(npy(Qt[i]), np.asarray(Qj[i]), atol=2e-5)
        np.testing.assert_allclose(npy(Pt[i]), np.asarray(Pj[i]), atol=2e-5)


def test_f64_rollout_matches_jax(port_run, jax_run):
    t, j = port_run, jax_run
    assert t["n_lost_f64"] == j["n_lost_f64"] == 0
    assert np.isfinite(t["mean_Eosc_f64"]) and t["t_f64_rollout_s"] > 0
    np.testing.assert_allclose(t["mean_Eosc_f64"], j["mean_Eosc_f64"],
                               rtol=RTOL_EOSC_F64)


@pytest.mark.parametrize("option", [{"compensated": True}])
def test_options_not_ported_raise(option):
    with pytest.raises(NotImplementedError):
        twl.run(n_train=8, nm=2, steps=1, device=CPU, **option)


def test_plots_write_the_portrait(tmp_path):
    """``plots``: the rollout's portrait beside the float64 reference
    sections, one a turn over max(nm // 4, 1) turns."""
    pytest.importorskip("matplotlib")
    out = twl.run(n_train=8, nm=4, steps=1, plots=str(tmp_path),
                  device=CPU)
    png = tmp_path / "tokamak_large_N8_portrait.png"
    assert out["portrait"] == str(png)
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert out["t_plots_s"] > 0


def test_cli_runs_tokamak_large(capsys):
    cli.main(["run", "tokamak_large", "--n", "48", "--steps", "3", "--nm",
              "3", "--sig2n", "1e-3", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["N"] == 48 and out["steps"] == 3 and out["nm"] == 3
    assert out["sig2n"] == 1e-3 and math.isfinite(out["nll_last"])
