"""``workloads/large_n.py`` on the card: ``measure(N=1024)`` launches each
of its stages' kernels (the build, both contractions, the syrk, the
triangular matmul and the rollout), its float32 gradients agree with
float64, and its deployment rollout and one ``rollout_sweep`` instance
through the rollout kernel agree with their plain version on their first
32 orbits over 2 steps.  Needs a CUDA device; skips otherwise.  Needs no
JAX:
  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_large_n.py
"""

import pytest

pytest.importorskip("torch")

import math  # noqa: E402

import torch  # noqa: E402

from sympgpr_tpu_torch.profiling import launch_counts  # noqa: E402
from sympgpr_tpu_torch.workloads import large_n  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def measured():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return large_n.measure(N=1024, reps=2, train_steps=3, device="cuda")


def test_measure_launches_each_stages_kernels(measured):
    launches = measured["launches"]
    assert set(launches) == set(large_n.STAGE_KERNELS)
    for stage, kernels in large_n.STAGE_KERNELS.items():
        launched = {k for k, n in launches[stage].items() if n > 0}
        assert launched == kernels, (stage, launches[stage])


def test_measure_results(measured):
    assert measured["dtype"] == "float32" and measured["n"] == 2048
    assert measured["nll_decreased"], measured
    assert measured["rollout_finite_frac"] == 1.0, measured
    for k in ("build_s", "cholesky_s", "nll_eval_s", "train_step_s",
              "train_step_autodiff_s", "adam_10step_s", "triinv_s",
              "syrk_s", "rollout_run_s"):
        assert math.isfinite(measured[k]) and measured[k] > 0, k


def test_float32_gradients_agree_with_float64(cuda):
    res = large_n.check_gradients(1024, device=cuda)
    assert res["ok"], res


def test_sweep_instance_kernel_is_plain(cuda):
    """The N=4096 instance of the sweep at its batch: the kernel against
    its plain version on 32 orbits over 2 steps."""
    _, pm, q0, p0 = list(large_n.sweep_instances((512, 4096), 4096,
                                                 cuda))[-1]
    before = launch_counts()["rollout"]
    res = large_n.sweep_check(pm, q0, p0, orbits=32, steps=2)
    assert launch_counts()["rollout"] == before + 1
    assert res["ok"], res


def test_deployment_rollout_kernel_is_plain(measured, cuda):
    """measure's deployment rollout, rebuilt from its trained theta: the
    kernel against its plain version on 32 orbits over 2 steps."""
    X, z = large_n.synthetic_training_set(1024, device=cuda)
    pm, q0, p0 = large_n.deployment_instance(
        torch.tensor(measured["rollout_theta"], device=cuda), X, z,
        torch.tensor(1e-2, device=cuda))
    before = launch_counts()["rollout"]
    res = large_n.sweep_check(pm, q0, p0, orbits=32, steps=2)
    assert launch_counts()["rollout"] == before + 1
    assert res["ok"], res
