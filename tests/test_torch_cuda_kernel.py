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

import dataclasses
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


def _diff(a, b) -> float:
    """max |a - b|, NaN in both counting 0 and NaN in one counting inf."""
    d = (a - b).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
    return float(d.nan_to_num(math.inf).max())


def _truncated(pm, n):
    """The packed models over the first ``n`` training points only (the
    rest are zero-alpha padding): ``ns`` need not be a multiple of 8."""
    return dataclasses.replace(
        pm, ns=n, **{f: getattr(pm, f)[:n].contiguous()
                     for f in ("uq", "uP", "a0", "a1")})


# forced team sizes, each with a training set that is no multiple of the
# team (T = 1: the whole slice of <= 8 points on one lane; T = 512: the
# float32 block without a solver warp; float64 teams end at 256 lanes).
# From (8, 100) on, lanes hold 13-16 points, so they run the instances
# that hold 16 (float32 288 x 2 and 512 x 1, float64 288 x 1); 256 x 16
# is what tokamak_large runs at N = 4096.
TEAMS = [(1, 6), (8, 37), (32, 40), (256, 1000), (512, 1000), (8, 100)]
TEAMS_LARGE = [(256, 4000), (512, 8000)]
TEAMS_F64 = [(t, n) for t, n in TEAMS + TEAMS_LARGE
             if t <= cs.team_max(torch.float64)]
AUX_POINTS = 1000  # an aux table that fits beside 512 lanes of 16 points


def _team_models(name, n, dtype, device):
    """Toy models fitted on ``n`` points (the aux GP on at most
    ``AUX_POINTS`` of them), packed over exactly ``n``."""
    X, z, Xp, zp = toy_data(n, seed=1)
    na = min(n, AUX_POINTS)
    k = kv.get_kernel(name)
    params = [0.9, 1.2, 0.55][: k.n_params]
    f64 = dict(dtype=torch.float64, device=device)
    sgp = SympGP.create(k, params, 1.5, 1e-2, torch.tensor(X, **f64), z)
    aux = AuxGP.create(k, params, 1.5, 1e-2, torch.tensor(Xp[:na], **f64),
                       zp[:na])
    return _truncated(cs.pack_models(sgp, aux, mod_q=2 * math.pi,
                                     dtype=dtype), n)


@pytest.mark.parametrize("name", ["per_se", "se_se", "per_se_freq"])
@pytest.mark.parametrize("team,n", TEAMS_F64)
def test_kernel_forced_team_float64(cuda, name, team, n):
    """Every team size against the plain version: 1e-9 over 100 steps,
    the same NaN pattern; a batch that is no multiple of the block."""
    f64 = dict(dtype=torch.float64, device=cuda)
    pm = _team_models(name, n, torch.float64, cuda)
    q0, p0 = (torch.tensor(x, **f64) for x in ics(2, b=77))
    geo = cs.launch_geometry(77, pm.ns, pm.nas, torch.float64, team=team)
    assert geo.team == team
    assert geo.teams_per_block == 1 or 77 % geo.teams_per_block
    Qk, Pk = cs._launch(pm, q0, p0, 100, 5, loss_check=True, team=team)
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 100, loss_check=True)
    assert torch.equal(torch.isnan(Pk), torch.isnan(Pr))
    assert max(_diff(Qk, Qr), _diff(Pk, Pr)) <= 1e-9


@pytest.mark.parametrize("team,n", TEAMS)
def test_kernel_forced_team_float32(cuda, team, n):
    """float32 at steps 1-2, the same NaN pattern: 1e-4, as the smoke
    holds the tokamak model (a 1000-point sum carries 5e-5 of float32
    rounding between two summation orders)."""
    pm = _team_models("per_se", n, torch.float32, cuda)
    q0, p0 = (torch.tensor(x, dtype=torch.float32, device=cuda)
              for x in ics(3, b=301))
    Qk, Pk = cs._launch(pm, q0, p0, 3, 5, loss_check=True, team=team)
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 3, loss_check=True)
    np.testing.assert_array_equal(npy(torch.isnan(Pk)), npy(torch.isnan(Pr)))
    assert max(_diff(Qk[1:3], Qr[1:3]), _diff(Pk[1:3], Pr[1:3])) <= 1e-4


@pytest.mark.parametrize("team,n", TEAMS_LARGE)
def test_kernel_forced_team_float32_large_n(cuda, team, n):
    """float32 over thousands of points: kernel and plain version differ
    by 2.0e-4 and 3.9e-4 at steps 1-2 at 4000 and 8000 points (H100),
    float32 rounding above the 1e-4 of the small cases.  So both are held
    against the float64 rollout of the same float32 columns: the kernel's
    L2 error within 3x the plain version's, as the smoke holds N = 4096;
    the same NaN pattern."""
    pm = _team_models("per_se", n, torch.float32, cuda)
    q0, p0 = (torch.tensor(x, dtype=torch.float32, device=cuda)
              for x in ics(3, b=301))
    Qk, Pk = cs._launch(pm, q0, p0, 3, 5, loss_check=True, team=team)
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 3, loss_check=True)
    exact = dataclasses.replace(
        pm, **{f: getattr(pm, f).double() for f in (
            "uq", "uP", "a0", "a1", "auxq", "auxp", "auxa", "scal")})
    Qx, Px = cs.rollout_reference(exact, q0.double(), p0.double(), 3,
                                  loss_check=True)
    np.testing.assert_array_equal(npy(torch.isnan(Pk)), npy(torch.isnan(Pr)))

    def err(Q, P) -> float:
        d = torch.cat([Q[1:3].double() - Qx[1:3], P[1:3].double() - Px[1:3]])
        return float(d[~torch.isnan(d)].norm())

    assert err(Qk, Pk) <= 3 * err(Qr, Pr)


def test_kernel_lost_mid_run_in_shared_warp(cuda):
    """Orbits lost at different steps while other teams of the same warp
    (team 8: four orbits a warp) run on: the same NaN pattern over 100
    steps, float64 at 1e-9."""
    pm = cs.pack_models(*_models("per_se", cuda), mod_q=2 * math.pi,
                        dtype=torch.float64)
    q0, p0 = (torch.tensor(x, dtype=torch.float64, device=cuda)
              for x in ics(4, b=64))
    p0 = p0.abs() * 0.3  # near the P < 0 boundary: lost over several steps
    Qk, Pk = cs._launch(pm, q0, p0, 100, 5, loss_check=True, team=8)
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 100, loss_check=True)
    lost = torch.isnan(Pr)
    first = lost.float().argmax(0)[lost[-1]]  # step each lost orbit is lost
    assert int(lost[-1].sum()) > int(lost[1].sum()) and int(first.max()) > 2
    assert torch.equal(torch.isnan(Pk), lost)
    assert max(_diff(Qk, Qr), _diff(Pk, Pr)) <= 1e-9


def test_kernel_float64_at_n4096(cuda):
    """float64 at the large-N path's N (4096 training, 512 aux points)
    runs through the kernel and matches the plain version over a few
    steps."""
    g = np.random.default_rng(7)
    n, na = 4096, 512
    X = np.stack([g.uniform(0, 2 * np.pi, n), g.uniform(0.5, 6, n)], 1)
    z = g.normal(size=2 * n) * 0.1
    f64 = dict(dtype=torch.float64, device=cuda)
    sgp = SympGP.create(kv.PER_SE, [0.9, 1.4], 2.0, 1e-2,
                        torch.tensor(X, **f64), z)
    aux = AuxGP.create(kv.PER_SE, [0.9, 1.4], 2.0, 1e-2,
                       torch.tensor(X[:na], **f64), z[:na])
    pm = cs.pack_models(sgp, aux, mod_q=2 * math.pi, dtype=torch.float64)
    assert pm.ns == cs.ns_max(torch.float64)
    q0, p0 = (torch.tensor(x, **f64) for x in ics(5, b=40))
    p0 = p0.abs() * 3 + 0.5
    Qk, Pk = cs.rollout_in_kernel(pm, q0, p0, 5, loss_check=True)
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 5, loss_check=True)
    assert torch.equal(torch.isnan(Pk), torch.isnan(Pr))
    assert int(torch.isnan(Pk[-1]).sum()) < 40
    assert max(_diff(Qk, Qr), _diff(Pk, Pr)) <= 1e-9
