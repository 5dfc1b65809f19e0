"""The hand-written CUDA rollout kernel against its plain PyTorch version,
on the card.

Needs a CUDA device and nvcc; skips otherwise.  Needs no JAX, so it runs
on a machine with the card alone:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernel.py

(``--noconftest``: the suite's conftest imports JAX.)  Tolerances:
float64 every step of a 100-step rollout at 1e-9 (two summation orders
and fused vs separate exps, ~1e-15 per step, on mostly regular orbits);
float32 at steps 1-2 at 2e-5, as ``tests/test_pallas_step.py``.
"""

import math

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import ics, npy, toy_data  # noqa: E402

from sympgpr_tpu_torch.gp.model import AuxGP, SympGP  # noqa: E402
from sympgpr_tpu_torch.kernels import variants as kv  # noqa: E402
from sympgpr_tpu_torch.ops import cuda_step as cs  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _models(name, device, sig2n=1e-2):
    X, z, Xp, zp = toy_data(40, seed=1)
    k = kv.get_kernel(name)
    params = [0.9, 1.2, 0.55][: k.n_params]
    f64 = dict(dtype=torch.float64, device=device)
    sgp = SympGP.create(k, params, 1.5, sig2n, torch.tensor(X, **f64), z)
    aux = AuxGP.create(k, params, 1.5, sig2n, torch.tensor(Xp, **f64), zp)
    return sgp, aux


@pytest.mark.parametrize("name", ["per_se", "se_se", "per_se_freq"])
def test_kernel_float64_matches_reference(cuda, name):
    pm = cs.pack_models(*_models(name, cuda), mod_q=2 * math.pi,
                        dtype=torch.float64)
    q0, p0 = (torch.tensor(x, dtype=torch.float64, device=cuda)
              for x in ics(2, b=200))
    p0 = p0.abs()
    before = cs.LAUNCHES
    Qk, Pk = cs.rollout_in_kernel(pm, q0, p0, 100, loss_check=True)
    torch.cuda.synchronize()
    assert cs.LAUNCHES == before + 1
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 100, loss_check=True)
    np.testing.assert_allclose(npy(Qk), npy(Qr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(npy(Pk), npy(Pr), rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", ["per_se", "se_se", "per_se_freq"])
def test_kernel_float32_matches_reference(cuda, name):
    pm = cs.pack_models(*_models(name, cuda), mod_q=2 * math.pi)
    q0, p0 = (torch.tensor(x, dtype=torch.float32, device=cuda)
              for x in ics(3, b=300))  # not a multiple of the block
    Qk, Pk = cs.rollout_in_kernel(pm, q0, p0, 3, loss_check=True)
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 3, loss_check=True)
    assert 0 < int(torch.isnan(Pk[1]).sum()) < 300  # P < 0 orbits lost
    np.testing.assert_array_equal(npy(torch.isnan(Pk)), npy(torch.isnan(Pr)))
    for i in (1, 2):
        np.testing.assert_allclose(npy(Pk[i]), npy(Pr[i]), atol=2e-5)
        np.testing.assert_allclose(npy(Qk[i]), npy(Qr[i]), atol=2e-5)


def test_kernel_rejects_cpu_mix(cuda):
    pm = cs.pack_models(*_models("per_se", cuda), mod_q=2 * math.pi)
    q0 = torch.zeros(8, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        cs.rollout_in_kernel(pm, q0, q0.cpu(), 3)
