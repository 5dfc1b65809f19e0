"""The port's ``run large_n --distributed`` and ``bench --large-n
--distributed`` at a world of one rank on the CPU (a process each), and
the summary's keys against the JAX package's ``run_distributed``."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cli(*argv: str) -> dict:
    """The port's CLI in its own process (its group is its own); the last
    line of its output as JSON."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "sympgpr_tpu_torch", *argv,
                        "--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_keys():
    """The keys of the JAX package's summary, from a small run on the
    conftest's CPU mesh."""
    from sympgpr_tpu.workloads import large_n

    return set(large_n.run_distributed(N=16, steps=1, block=8))


def test_run_large_n_distributed(jax_keys):
    """N=64, 3 steps: the JAX keys, float64 on gloo at world 1, the fit
    descends, alpha on the dense solve, and the checkpoint loads."""
    from sympgpr_tpu_torch.gp.model import load_models

    out = _cli("run", "large_n", "--distributed", "--n", "64", "--steps",
               "3")
    assert set(out) == jax_keys
    assert (out["N"], out["devices"], out["steps"]) == (64, 1, 3)
    assert out["mesh"] == "gloo" and out["dtype"] == "float64"
    assert out["nll_decreased"] and np.all(np.isfinite(out["hyp"]))
    assert out["alpha_vs_dense_rel"] < 1e-8
    assert out["per_device_K_bytes"] == 128 ** 2 * 8
    model, _, _ = load_models(out["checkpoint"], "cpu")
    assert model.alpha.shape == (128,)


def test_bench_large_n_distributed(jax_keys):
    """``bench --large-n --distributed --steps``: the JAX package's metric
    around the same summary."""
    out = _cli("bench", "--large-n", "--distributed", "--n", "32",
               "--steps", "2")
    assert out["metric"] == "large_n_distributed_fit_s"
    assert out["unit"] == "s" and out["value"] > 0
    assert set(out["detail"]) == jax_keys
    assert out["detail"]["steps"] == 2
    assert out["value"] == out["detail"]["t_train_s"]
