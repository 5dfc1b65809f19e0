"""The kernel registry (``kernels/variants.py``) is where the port's
closed-form paths look a kernel up: a ``Kernel`` made outside it takes the
generic paths.  Port only, on the CPU in float64."""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import ics, npy, t64, toy_data  # noqa: E402

from sympgpr_tpu_torch.gp import covariance  # noqa: E402
from sympgpr_tpu_torch.kernels import variants  # noqa: E402


def test_kernel_outside_registry_takes_generic_paths(monkeypatch):
    """A ``Kernel`` made outside the registry has no code and no q-side
    form: the autodiff build in ``build_K_fast`` and ``nll_batched``, the
    generic map in ``apply_map`` and ``apply_map_split``, no CUDA build,
    and ``pack_models`` refuses it by name."""
    from sympgpr_tpu_torch.gp import likelihood
    from sympgpr_tpu_torch.gp.model import AuxGP, SympGP
    from sympgpr_tpu_torch.maps import symplectic
    from sympgpr_tpu_torch.ops import cuda_cov, cuda_step

    k = variants.Kernel("per_se_outside", 2, variants.PER_SE.fn)
    assert k.code is None and k.q_factors is None
    assert not k.fast_map and not k.product
    X, z, Xp, zp = (t64(a) for a in toy_data(n=10, seed=2))
    p, sig = t64([0.9, 1.7]), t64(1.3)
    assert torch.equal(covariance.build_K_fast(k, X, X, p, sig),
                       covariance.build_K(k, X, X, p, sig))
    autodiff, build_K = [], covariance.build_K
    monkeypatch.setattr(covariance, "build_K", lambda kernel, *a: (
        autodiff.append(kernel.name) or build_K(kernel, *a)))
    v = likelihood.nll_batched(k, p[None], sig[None], 1e-6, X, z)
    v_ref = likelihood.nll_batched(variants.PER_SE, p[None], sig[None], 1e-6,
                                   X, z)
    assert autodiff == ["per_se_outside"]  # PER_SE's build: closed form
    np.testing.assert_allclose(npy(v), npy(v_ref), rtol=1e-10)
    monkeypatch.undo()

    # the fast path would refuse the kernel (no q-side form)
    sgp = SympGP.create(k, p, 1.5, 1e-4, X, z)
    aux = AuxGP.create(k, t64([0.9, 1.2]), 1.5, 1e-4, Xp, zp)
    q0, p0 = (t64(a) for a in ics(3, b=6))
    for got, ref in (
            (symplectic.apply_map(sgp, aux, q0, p0, 3),
             symplectic.apply_map(sgp, aux, q0, p0, 3, prefer_fast=False)),
            (symplectic.apply_map_split([sgp] * 2, [aux] * 2, q0, p0, 3, 2),
             symplectic.apply_map_split([sgp] * 2, [aux] * 2, q0, p0, 3, 2,
                                        prefer_fast=False))):
        np.testing.assert_array_equal(npy(got.q), npy(ref.q))
        np.testing.assert_array_equal(npy(got.p), npy(ref.p))

    X32 = X.float()
    monkeypatch.setattr(cuda_cov, "NLL_THRESHOLD", 1)
    assert cuda_cov.want_cuda_build(variants.PER_SE, X32)
    assert not cuda_cov.want_cuda_build(k, X32)
    with pytest.raises(ValueError, match="per_se_outside"):
        cuda_step.pack_models(sgp, aux, mod_q=2 * np.pi)
