"""The port's ``sample``, ``sobol`` and ``run --optimizer adam`` commands:
JAX's keys, JAX's sampling problems and start points, and no silent CPU
path for ``--device cuda``."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, npy  # noqa: E402

from sympgpr_tpu_torch import __main__ as cli  # noqa: E402
from sympgpr_tpu_torch.gp import hmc  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the keys JAX's cmd_sample prints (sympgpr_tpu/__main__.py, cmd_sample),
# NUTS adding mean_depth and divergences; cmd_sobol's
SAMPLE_KEYS = ["workload", "sampler", "chains", "samples_per_chain",
               "accept_rate", "theta_mean", "theta_std", "hyp_posterior_mean"]
SOBOL_KEYS = ["params", "S1", "ST", "var"]


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
def test_sample_prints_jax_keys_and_saves_them(sampler, capsys, tmp_path):
    save = tmp_path / "s.npz"
    cli.main(["sample", "pendulum_implicit", "--device", "cpu",
              "--sampler", sampler, "--chains", "2", "--samples", "10",
              "--warmup", "10", "--save", str(save)])
    out = _last_json(capsys)
    extra = ["mean_depth", "divergences"] if sampler == "nuts" else []
    assert list(out) == SAMPLE_KEYS + extra
    assert out["chains"] == 2 and out["samples_per_chain"] == 10
    assert list(out["theta_mean"]) == ["l0", "l1", "sig"]
    assert 0.0 <= out["accept_rate"] <= 1.0
    with np.load(save) as f:
        assert sorted(f.files) == ["log_probs", "samples"]
        assert f["samples"].shape == (2, 10, 3)
        assert np.isfinite(f["log_probs"]).all()


@pytest.mark.parametrize("name", ["pendulum_implicit",
                                  "pendulum_period_unknown", "standard_map",
                                  "tokamak"])
def test_sample_problems_and_start_points_are_jax(name):
    """The same training sets (1e-12), kernel, sig2n and x0 as JAX's
    ``_sample_problem``, and the same numpy start points."""
    from sympgpr_tpu import __main__ as jcli

    kj, Xj, zj, s2j, _, x0j = jcli._sample_problem(name)
    kt, Xt, zt, s2t, x0t = cli._sample_problem(name, CPU)
    assert kt.name == kj.name and s2t == s2j
    np.testing.assert_array_equal(x0t, x0j)
    np.testing.assert_allclose(npy(Xt), np.asarray(Xj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(npy(zt), np.asarray(zj), rtol=1e-12,
                               atol=1e-12)
    rng = np.random.default_rng(5)
    want = x0j[None, :] + 0.05 * rng.standard_normal((8, len(x0j)))
    np.testing.assert_array_equal(hmc.start_points(x0t, 8, 5), want)


def test_sobol_runs_with_jax_keys(capsys):
    cli.main(["sobol", "--n", "8", "--turns", "2", "--device", "cpu"])
    out = _last_json(capsys)
    assert list(out) == SOBOL_KEYS and out["params"] == ["eps", "phase"]
    assert np.all(np.isfinite(out["S1"] + out["ST"])) and out["var"] > 0


def test_run_takes_adam(capsys):
    cli.main(["run", "tokamak", "--optimizer", "adam", "--nm", "3",
              "--device", "cpu"])
    out = _last_json(capsys)
    assert out["optimizer"] == "adam"
    assert np.isfinite(out["training_error"]) and np.isfinite(out["mean_gd"])


@pytest.mark.parametrize("argv", [["sample", "pendulum_implicit"],
                                  ["sobol", "--n", "8"]])
def test_cuda_device_needs_a_gpu(argv):
    """``--device cuda`` (the default) fails with a message rather than run
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    code = ("import runpy, sys\n"
            f"sys.argv = ['sympgpr_tpu_torch'] + {argv!r}\n"
            "runpy.run_module('sympgpr_tpu_torch', run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
