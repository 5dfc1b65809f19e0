"""The benchmark's plain reference against the program's plain path, in
float64 at small sizes on the CPU: the field-line integrator, the map step
and the NLL with its closed-form gradient."""

import math

import numpy as np
import pytest
import torch

from gpbench.harness import HERE, read_json
from gpbench.reference import gp as ref_gp
from gpbench.reference.systems import tokamak as ref_tk

F64 = torch.float64
KERN = ref_gp.kernel("per_se")  # the reference kernel


def _config(N: int) -> dict:
    return dict(read_json(HERE / "configs" / "tokamak.json"), N=N)


def _pairs(N: int, block: int = 0):
    return ref_tk.pairs(_config(N), [block], "cpu")[0]


def test_integrator_matches_program():
    from sympgpr_tpu_torch.systems import tokamak as tk

    d = _pairs(16)
    p = tk.training_data(tk.TokamakConfig(N=16), "cpu")
    for k in ("q", "p", "Q", "P"):
        torch.testing.assert_close(d[k], p[k][:, 0], rtol=1e-13, atol=1e-13)


def test_halton_matches_program():
    from sympgpr_tpu_torch.systems.halton import halton

    np.testing.assert_array_equal(ref_tk.halton(40, 3, 81),
                                  halton(40, 3, start=81))


@pytest.mark.parametrize("N", [40, 80])
def test_map_step_matches_program(N):
    from sympgpr_tpu_torch import PER_SE, AuxGP, SympGP
    from sympgpr_tpu_torch.maps.fast_apply import map_step
    from sympgpr_tpu_torch.maps.symplectic import MapConfig

    d = _pairs(N)
    X = torch.stack([d["q"], d["P"]], 1)
    z = torch.cat([d["p"] - d["P"], d["Q"] - d["q"]])
    Xa = torch.stack([d["q"], d["p"]], 1)
    sgp = SympGP.create(PER_SE, [0.8, 0.7], 18.0, 1e-8, X, z)
    aux = AuxGP.create(PER_SE, [0.5, 2.0], 1.1, 1e-8, Xa, d["P"] - d["p"])
    g = torch.Generator().manual_seed(N)
    q = 2 * math.pi * torch.rand(50, generator=g, dtype=F64)
    r = 0.15 + 0.1 * torch.rand(50, generator=g, dtype=F64)
    p = ref_tk.Ath(r, q) * 100.0
    cfg = MapConfig(newton_tol=1e-14, newton_maxiter=50, mod_q=None)
    Qp, Pp, _ = map_step(sgp, aux, q, p, 0, cfg)
    # the same alpha on both sides: the step alone is compared
    model = dict(kern=KERN, X=X, alpha=sgp.alpha, lx=0.8, ly=0.7, sig=18.0, Xa=Xa,
                 alpha_a=aux.alpha, alx=0.5, aly=2.0, asig=1.1, mod_q=None,
                 mod_p=None)
    Q, P, _ = ref_gp.map_step(model, q, p)
    # sums over N points of alpha ~ 1e2 in another order
    torch.testing.assert_close(P, Pp, rtol=1e-11, atol=1e-11)
    torch.testing.assert_close(Q, Qp, rtol=1e-11, atol=1e-11)
    # and alpha solved by the reference agrees with the program's
    torch.testing.assert_close(
        ref_gp.solve(ref_gp.cov(KERN, X, X, 0.8, 0.7, 18.0), 1e-8, z), sgp.alpha,
        rtol=1e-6, atol=1e-6 * float(sgp.alpha.abs().max()))


def test_covariance_matches_program():
    from sympgpr_tpu_torch import get_kernel
    from sympgpr_tpu_torch.gp.covariance import build_K, build_Kreg

    kern = get_kernel("per_se")  # the program's kernel by the same name
    d = _pairs(20)
    X = torch.stack([d["q"], d["P"]], 1)
    hyp = torch.tensor([0.6, 1.3], dtype=F64)
    torch.testing.assert_close(ref_gp.cov(KERN, X, X, 0.6, 1.3, 7.0),
                               build_K(kern, X, X, hyp, torch.tensor(
                                   7.0, dtype=F64)), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(KERN.cov_reg(X, X, 0.6, 1.3, 7.0),
                               build_Kreg(kern, X, X, hyp, torch.tensor(
                                   7.0, dtype=F64)), rtol=1e-12, atol=1e-12)


def test_nll_and_gradient_match_program():
    from sympgpr_tpu_torch import PER_SE
    from sympgpr_tpu_torch.gp.likelihood import nll_value_and_grad_theta

    d = _pairs(48)
    X = torch.stack([d["q"], d["P"]], 1)
    z = torch.cat([d["p"] - d["P"], d["Q"] - d["q"]])
    theta = torch.log10(torch.tensor([0.5, 2.5, 2.0], dtype=F64))
    s2n = torch.tensor(1e-2, dtype=F64)
    v, g = nll_value_and_grad_theta(PER_SE, theta, s2n, X, z)
    vr, gr = ref_gp.nll_and_grad_theta(KERN, X, z, theta, 1e-2)
    torch.testing.assert_close(vr, v, rtol=1e-11, atol=0)
    torch.testing.assert_close(gr, g, rtol=1e-9, atol=1e-9)


def test_adam_matches_program():
    from sympgpr_tpu_torch import PER_SE, fit_sympgp_ondevice

    d = _pairs(32)
    X = torch.stack([d["q"], d["P"]], 1)
    z = torch.cat([d["p"] - d["P"], d["Q"] - d["q"]])
    model, hist, _, _ = fit_sympgp_ondevice(PER_SE, X, z, sig2n=1e-2,
                                            theta0=(0.5, 2.5, 2.0), steps=8,
                                            lr=5e-2)
    theta, hist_r = ref_gp.adam(KERN, X, z, (0.5, 2.5, 2.0), 1e-2, 8,
                                5e-2)
    np.testing.assert_allclose(hist_r.numpy(), hist, rtol=1e-10)
    hyp = torch.cat([model.params, model.sig.reshape(1)])
    torch.testing.assert_close(10.0 ** theta, hyp, rtol=1e-10, atol=0)


def test_loss_boundary():
    cfg = _config(80)
    q = torch.zeros(3, dtype=F64)
    P = ref_tk.Ath(torch.tensor([0.3, 0.49, 0.51], dtype=F64), q) * 100.0
    assert ref_tk.lost(cfg, P, q).tolist() == [False, False, True]
    assert bool(ref_tk.lost(cfg, torch.tensor([-1e-3], dtype=F64),
                            torch.zeros(1, dtype=F64)))
    near = ref_tk.Ath(torch.tensor([0.49999, 0.45], dtype=F64),
                      q[:2]) * 100.0
    assert ref_tk.near_boundary(cfg, near, q[:2], 1e-4).tolist() == [
        True, False]
