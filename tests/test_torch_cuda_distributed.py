"""The distributed slice on the card at a world of one rank over NCCL: the
float64 distributed value and gradient at N=1024 against the
single-device float64 NLL, and the dp-sharded rollout through the CUDA
kernel against its plain version (``ops/rollout_check.py``'s rules).
Needs a CUDA device; skips otherwise.  Needs no JAX:
  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_distributed.py
"""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def mesh():
    """A world of one rank on NCCL and its one-axis meshes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from sympgpr_tpu_torch.distributed import init as dinit

    dinit.initialize("cuda")
    assert dist.get_backend() == "nccl"
    yield {axis: init_device_mesh("cuda", (1,), mesh_dim_names=(axis,))
           for axis in ("kp", "dp")}
    dinit.shutdown()


def test_value_and_grad_float64_matches_nll(mesh):
    """N=1024 (K 2048^2) at the workload's theta0: value 1e-9, gradient
    1e-7 relative, against autograd of ``gp/likelihood.py::nll``."""
    from sympgpr_tpu_torch.distributed.large import \
        sharded_nll_large_value_and_grad
    from sympgpr_tpu_torch.gp.likelihood import nll
    from sympgpr_tpu_torch.kernels import PER_SE
    from sympgpr_tpu_torch.workloads import large_n

    X, z = large_n.synthetic_training_set(1024, torch.float64, device="cuda")
    theta = torch.tensor(large_n.DIST_X0, dtype=torch.float64, device="cuda")
    s2n = torch.tensor(1e-2, dtype=torch.float64, device="cuda")
    v, g = sharded_nll_large_value_and_grad(PER_SE, mesh["kp"], theta, s2n,
                                            X, z, block=64)
    th = theta.clone().requires_grad_(True)
    hyp = 10.0 ** th
    ref = nll(PER_SE, hyp[:-1], hyp[-1], s2n, X, z)
    (g_ref,) = torch.autograd.grad(ref, th)
    np.testing.assert_allclose(float(v), float(ref), rtol=1e-9)
    np.testing.assert_allclose(g.cpu().numpy(), g_ref.cpu().numpy(),
                               rtol=1e-7)


def test_sharded_rollout_launches_the_kernel(mesh):
    """The dp-sharded rollout launches the kernel once and holds its first
    32 orbits over 2 steps to the plain version against float64."""
    from sympgpr_tpu_torch.distributed.sharded import \
        rollout_in_kernel_sharded
    from sympgpr_tpu_torch.ops import cuda_step, rollout_check
    from sympgpr_tpu_torch.workloads import large_n

    pm, q0, p0 = large_n.sweep_models(256, 2048, np.random.default_rng(3),
                                      "cuda")
    cuda_step.LAUNCHES = 0
    got = rollout_in_kernel_sharded(mesh["dp"], pm, q0, p0, 3)
    assert cuda_step.LAUNCHES == 1
    assert got[0].shape == (3, 2048)
    q, p = q0[:32].contiguous(), p0[:32].contiguous()
    ref = cuda_step.rollout_reference(pm, q, p, 3)
    res = rollout_check.f32_vs_f64(pm, q, p, {},
                                   tuple(t[:, :32] for t in got), ref)
    assert res["nan_pattern_equal"], res
    assert res["err_kernel"] <= res["err_bound"], res
    assert res["residual_kernel"] <= res["residual_bound"], res
