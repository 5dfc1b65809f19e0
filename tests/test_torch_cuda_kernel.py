"""The hand-written CUDA rollout kernel against its plain PyTorch version,
on the card.

Needs a CUDA device and nvcc; skips otherwise.  Needs no JAX, so it runs
on a machine with the card alone:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernel.py

(``--noconftest``: the suite's conftest imports JAX.)  Tolerances:
float64 every step of a 100-step rollout at 1e-9 (two summation orders
and fused vs separate exps, ~1e-15 per step, on mostly regular orbits);
float32 at steps 1-2 at 2e-5, as ``tests/test_pallas_step.py``.  The
explicit update, Algorithm 2 and mod_p / pdiff are held the same way, at
every team size.
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
from sympgpr_tpu_torch.profiling import launch_counts  # noqa: E402

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
    before = launch_counts()["rollout"]
    Qk, Pk = cs.rollout_in_kernel(pm, q0, p0, 100, loss_check=True)
    torch.cuda.synchronize()
    assert launch_counts()["rollout"] == before + 1
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


def _circ(d, period):
    """A difference of two angles on their circle of ``period`` (as it is
    where ``period`` is None)."""
    if period is None:
        return d
    return torch.remainder(d + period / 2, period) - period / 2


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


# --- cluster teams: one orbit over a thread-block cluster -----------------

CLUSTERS = [1, 2, 4, 8]


@pytest.fixture(scope="module")
def cluster_models():
    """tokamak_large's shape (N = 4096 training points) as toy models,
    packed in float32 and float64, and 30 initial conditions whose P is
    0.2 or more from 0 (the toy map keeps P's sign), half of them below:
    those orbits are lost at once, the others never, in every summation
    order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    pms = {dt: _team_models("per_se", 4096, dt, dev)
           for dt in (torch.float32, torch.float64)}
    q0, p0 = (torch.tensor(x, dtype=torch.float64, device=dev)
              for x in ics(5, b=30))
    p0 = torch.where(p0 < 0, p0 - 0.2, p0 + 0.2)
    return pms, q0, p0


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_cluster_team_float32(cluster_models, cluster):
    """A forced cluster of C blocks at 30 x 200, N = 4096: the NaN pattern
    of the one-block team and of the plain version; steps 1-2 within 3x
    the plain float32 error against the float64 rollout of the same
    columns (as test_kernel_forced_team_float32_large_n); the same bits
    launch after launch; each cluster launch counted."""
    pms, q0, p0 = cluster_models
    pm, q0, p0 = pms[torch.float32], q0.float(), p0.float()
    geo = cs.launch_geometry(30, pm.ns, pm.nas, torch.float32,
                             cluster=cluster)
    assert geo.cluster == cluster and geo.per_lane == 16 // cluster
    before = launch_counts()
    Qk, Pk = cs._launch(pm, q0, p0, 200, 5, loss_check=True,
                        cluster=cluster)
    after = launch_counts()
    assert after["rollout"] == before["rollout"] + 1
    assert after["rollout_cluster"] == before["rollout_cluster"] + (
        cluster > 1)
    Q1, P1 = cs._launch(pm, q0, p0, 200, 5, loss_check=True, cluster=1)
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 200, loss_check=True)
    lost = torch.isnan(Pr)
    assert 0 < int(lost[-1].sum()) < 30
    assert torch.equal(torch.isnan(Pk), lost)
    assert torch.equal(torch.isnan(P1), lost)
    assert torch.equal(torch.isnan(Qk), torch.isnan(Qr))
    exact = dataclasses.replace(
        pm, **{f: getattr(pm, f).double() for f in (
            "uq", "uP", "a0", "a1", "auxq", "auxp", "auxa", "scal")})
    Qx, Px = cs.rollout_reference(exact, q0.double(), p0.double(), 3,
                                  loss_check=True)

    def err(Q, P) -> float:
        d = torch.cat([Q[1:3].double() - Qx[1:3], P[1:3].double() - Px[1:3]])
        return float(d[~torch.isnan(d)].norm())

    assert err(Qk, Pk) <= 3 * err(Qr, Pr)
    Q2, P2 = cs._launch(pm, q0, p0, 200, 5, loss_check=True,
                        cluster=cluster)
    assert torch.equal(Qk.view(torch.int32), Q2.view(torch.int32))
    assert torch.equal(Pk.view(torch.int32), P2.view(torch.int32))


def test_cluster_team_float64(cluster_models):
    """float64 with a cluster of 4 blocks at 30 x 200, N = 4096: the NaN
    pattern of the plain version; its first 100 rows within 1e-10 of it,
    and all 200 within 3x the one-block team's own distance from it (two
    summation orders of 4096-point float64 sums part by ~1e-10 over 200
    steps: on an H100 7.7e-11 in one block, 1.02e-10 over 4, 7.7e-11 and
    7.7e-11 over the first 100 rows); the launch's rule takes the same
    cluster by itself (one cluster launch)."""
    pms, q0, p0 = cluster_models
    pm = pms[torch.float64]
    Qk, Pk = cs._launch(pm, q0, p0, 200, 5, loss_check=True, cluster=4)
    Q1, P1 = cs._launch(pm, q0, p0, 200, 5, loss_check=True, cluster=1)
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 200, loss_check=True)
    assert torch.equal(torch.isnan(Pk), torch.isnan(Pr))
    assert max(_diff(Qk[:100], Qr[:100]), _diff(Pk[:100], Pr[:100])) <= 1e-10
    assert max(_diff(Qk, Qr), _diff(Pk, Pr)) <= 3 * max(_diff(Q1, Qr),
                                                        _diff(P1, Pr))
    before = launch_counts()["rollout_cluster"]
    Qa, Pa = cs.rollout_in_kernel(pm, q0, p0, 200, loss_check=True)
    assert launch_counts()["rollout_cluster"] == before + 1
    for a, b in ((Qa, Qk), (Pa, Pk)):  # the same bits, NaN rows too
        assert torch.equal(a.view(torch.int64), b.view(torch.int64))


# --- Split cycling and the loss check at the new q -------------------------

# forced team sizes over M = 1, 2 and 4 sub-maps of different sizes (row i
# is made by sub-map (i - 1) mod M); the aux tables of all sub-maps share a
# block's shared memory with the longer rows, so the wide cases take 300
# aux points a sub-map
SPLIT_CASES = [  # team, the sub-maps' training points
    (1, (8, 5)), (1, (8, 5, 7, 3)), (8, (37, 20)), (8, (37, 20, 29, 12)),
    (32, (40,)), (32, (40, 24, 33, 17)), (256, (1000, 600)),
    (512, (1000, 600, 800, 300))]
SPLIT_F64 = [c for c in SPLIT_CASES if c[0] <= cs.team_max(torch.float64)]
SPLIT_AUX = 300


def _split_models(sizes, dtype, device, name="per_se"):
    """Sub-maps that differ (their own points, targets and
    hyperparameters), packed together."""
    k = kv.get_kernel(name)
    f64 = dict(dtype=torch.float64, device=device)
    sgps, auxes = [], []
    for m, n in enumerate(sizes):
        X, z, Xp, zp = toy_data(n, seed=10 + m)
        params = [0.9 + 0.1 * m, 1.2 - 0.1 * m, 0.55][: k.n_params]
        na = min(n, SPLIT_AUX)
        sgps.append(SympGP.create(k, params, 1.5, 1e-2,
                                  torch.tensor(X, **f64), z))
        auxes.append(AuxGP.create(k, params, 1.5, 1e-2,
                                  torch.tensor(Xp[:na], **f64), zp[:na]))
    return cs.pack_models_split(sgps, auxes, mod_q=2 * math.pi, dtype=dtype)


@pytest.mark.parametrize("new_q", [False, True])
@pytest.mark.parametrize("team,sizes", SPLIT_F64)
def test_split_kernel_forced_team_float64(cuda, team, sizes, new_q):
    """Every team size with 1, 2 and 4 sub-maps against the plain version:
    1e-9 over 100 steps, the same NaN pattern, a batch that is no multiple
    of the block; the loss check at the old or the new q."""
    f64 = dict(dtype=torch.float64, device=cuda)
    pm = _split_models(sizes, torch.float64, cuda)
    assert pm.n_maps == len(sizes)
    q0, p0 = (torch.tensor(x, **f64) for x in ics(2, b=77))
    Qk, Pk = cs._launch(pm, q0, p0, 100, 5, loss_check=True, team=team,
                        loss_at_new_q=new_q)
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 100, loss_check=True,
                                  loss_at_new_q=new_q)
    assert torch.equal(torch.isnan(Pk), torch.isnan(Pr))
    assert max(_diff(Qk, Qr), _diff(Pk, Pr)) <= 1e-9


@pytest.mark.parametrize("team,sizes", SPLIT_CASES)
def test_split_kernel_forced_team_float32(cuda, team, sizes):
    """float32 at steps 1-2 at 1e-4 (as test_kernel_forced_team_float32),
    the same NaN pattern, the loss check at the new q."""
    pm = _split_models(sizes, torch.float32, cuda)
    q0, p0 = (torch.tensor(x, dtype=torch.float32, device=cuda)
              for x in ics(3, b=301))
    Qk, Pk = cs._launch(pm, q0, p0, 3, 5, loss_check=True, team=team,
                        loss_at_new_q=True)
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 3, loss_check=True,
                                  loss_at_new_q=True)
    np.testing.assert_array_equal(npy(torch.isnan(Pk)), npy(torch.isnan(Pr)))
    assert max(_diff(Qk[1:3], Qr[1:3]), _diff(Pk[1:3], Pr[1:3])) <= 1e-4


@pytest.mark.parametrize("name", ["per_se", "se_se", "per_se_freq"])
def test_split_kernel_kinds_float64(cuda, name):
    """All three kinds with four sub-maps (per_se_freq: each sub-map its
    own frequency), the default geometry, 1e-9 over 100 steps."""
    pm = _split_models((40, 24, 33, 17), torch.float64, cuda, name)
    q0, p0 = (torch.tensor(x, dtype=torch.float64, device=cuda)
              for x in ics(4, b=200))
    Qk, Pk = cs.rollout_in_kernel(pm, q0, p0, 100, loss_check=True,
                                  loss_at_new_q=True)
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 100, loss_check=True,
                                  loss_at_new_q=True)
    assert torch.equal(torch.isnan(Pk), torch.isnan(Pr))
    assert max(_diff(Qk, Qr), _diff(Pk, Pr)) <= 1e-9


@pytest.mark.parametrize("sizes,new_q,split", [
    ((40, 24, 33, 17), True, True), ((40, 24, 33, 17), False, True),
    ((40,), True, True), ((40,), False, False)],
    ids=["four_maps_new_q", "four_maps_old_q", "one_map_new_q",
         "one_map_old_q"])
def test_split_launches_counted(cuda, sizes, new_q, split):
    """A launch of a Split instance (sub-map cycling, or the loss check at
    the new q with one map) raises ``rollout_split`` by one; a one-map
    launch at the old q leaves it as it was."""
    pm = _split_models(sizes, torch.float32, cuda)
    q0, p0 = (torch.tensor(x, dtype=torch.float32, device=cuda)
              for x in ics(3, b=30))
    before = launch_counts()
    cs.rollout_in_kernel(pm, q0, p0, 10, loss_check=True,
                         loss_at_new_q=new_q)
    after = launch_counts()
    assert after["rollout"] == before["rollout"] + 1
    assert after["rollout_split"] == before["rollout_split"] + split


def _stdmap_models(device):
    """The standard map's implicit models at k = 2 on its 20 Halton pairs
    (the port's float64 fits' hyperparameters)."""
    from sympgpr_tpu_torch.systems import standard_map as sm

    d = sm.training_data(sm.StandardMapConfig(), device)
    sgp = SympGP.create(kv.PER_SE, [10.77, 5.295], 80.66, 1e-12, d["X"],
                        d["z"])
    aux = AuxGP.create(kv.PER_SE, [0.1, 0.1], 8.0, 1e-12, d["Xp"], d["zp"],
                       delta=True)
    return sgp.for_deployment(1e-5), aux.for_deployment(1e-5)


@pytest.mark.parametrize("case,wrap", [
    ("tokamak", 0), ("split", 0), ("stdmap_mod_p", 1), ("stdmap_pdiff", 1),
    ("stdmap_both", 1)])
def test_wrap_launches_counted(cuda, case, wrap):
    """A launch in the mod_p / pdiff mode (``kernel_mode`` "implicit_wrap":
    the standard map with the wrap of P, with pdiff, or both) raises
    ``rollout_wrap`` by one; a tokamak launch and a Split launch leave it
    as it was."""
    two_pi = 2 * math.pi
    kw = {}
    if case == "tokamak":
        pm = cs.pack_models(*_models("per_se", cuda), mod_q=two_pi)
    elif case == "split":
        pm = _split_models((40, 24, 33, 17), torch.float32, cuda)
        kw = dict(loss_at_new_q=True)
    else:
        pm = cs.pack_models(*_stdmap_models(cuda), mod_q=two_pi,
                            mod_p=None if case == "stdmap_pdiff" else two_pi)
        kw = dict(track_pdiff=case != "stdmap_mod_p")
    q0, p0 = (torch.tensor(x, dtype=torch.float32, device=cuda)
              for x in ics(3, b=30))
    p0 = p0.abs()
    before = launch_counts()
    out = cs.rollout_in_kernel(pm, q0, p0, 10, **kw)
    after = launch_counts()
    assert len(out) == (3 if kw.get("track_pdiff") else 2)
    assert after["rollout"] == before["rollout"] + 1
    assert after["rollout_wrap"] == before["rollout_wrap"] + wrap
    assert after["rollout_split"] == before["rollout_split"] + (
        case == "split")


def _boundary_models(device):
    """Two sub-maps near the tokamak's loss boundary (P in [10, 14]: r =
    0.5 at cos q = 0.12 for P = 12) that turn q by ~1 and ~0.5 a step."""
    f64 = dict(dtype=torch.float64, device=device)
    sgps, auxes = [], []
    for m, (n, shift) in enumerate(((24, 1.0), (16, 0.5))):
        rng = np.random.default_rng(m)
        q, P = rng.uniform(0, 2 * np.pi, n), rng.uniform(10, 14, n)
        z = np.concatenate([0.01 * np.sin(q), shift + 0.1 * np.cos(q)])
        X = torch.tensor(np.stack([q, P], 1), **f64)
        sgps.append(SympGP.create(kv.PER_SE, [0.9, 1.2], 1.5, 1e-2, X, z))
        auxes.append(AuxGP.create(kv.PER_SE, [0.9, 1.2], 1.5, 1e-2, X,
                                  np.zeros(n)))
    return sgps, auxes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_new_q_check_nan_rows(cuda, dtype):
    """On the loss boundary: an orbit lost at step i is NaN from row i on,
    in the kernel as in the plain version, and the checks at the old and
    the new q lose other orbits at other steps."""
    pm = cs.pack_models_split(*_boundary_models(cuda), mod_q=2 * math.pi,
                              dtype=dtype)
    q0 = torch.linspace(0, 2 * math.pi, 301, dtype=dtype, device=cuda)
    p0 = torch.full_like(q0, 12.0)
    lost = {}
    for new_q in (False, True):
        Qk, Pk = cs.rollout_in_kernel(pm, q0, p0, 8, loss_check=True,
                                      loss_at_new_q=new_q)
        Qr, Pr = cs.rollout_reference(pm, q0, p0, 8, loss_check=True,
                                      loss_at_new_q=new_q)
        nan = torch.isnan(Pk)
        assert torch.equal(nan, torch.isnan(Pr))
        assert torch.equal(nan, torch.isnan(Qk))
        assert torch.equal(nan, torch.cummax(nan.int(), 0).values.bool())
        steps = 8 if dtype == torch.float64 else 3
        atol = 1e-9 if dtype == torch.float64 else 1e-4
        assert max(_diff(Qk[:steps], Qr[:steps]),
                   _diff(Pk[:steps], Pr[:steps])) <= atol
        lost[new_q] = nan
    assert 0 < int(lost[True][1].sum()) < 301
    assert not torch.equal(lost[True], lost[False])


@pytest.mark.parametrize("sizes", [(40,), (40, 24, 33, 17)])
def test_kernel_bitwise_deterministic(cuda, sizes):
    """Two launches give the same bits (fixed-order team sums, no
    atomics), one map and four."""
    pm = _split_models(sizes, torch.float32, cuda)
    q0, p0 = (torch.tensor(x, dtype=torch.float32, device=cuda)
              for x in ics(5, b=1000))
    a = cs.rollout_in_kernel(pm, q0, p0, 200, loss_check=True,
                             loss_at_new_q=len(sizes) > 1)
    b = cs.rollout_in_kernel(pm, q0, p0, 200, loss_check=True,
                             loss_at_new_q=len(sizes) > 1)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_pack_models_one_map_unchanged(cuda):
    """One map: pack_models is pack_models_split of one, and the same
    model repeated as two sub-maps runs the Split instance to the same
    bits as the one-map instance."""
    sgp, aux = _models("per_se", cuda)
    one = cs.pack_models(sgp, aux, mod_q=2 * math.pi)
    split1 = cs.pack_models_split([sgp], [aux], mod_q=2 * math.pi)
    twice = cs.pack_models_split([sgp, sgp], [aux, aux], mod_q=2 * math.pi)
    q0, p0 = (torch.tensor(x, dtype=torch.float32, device=cuda)
              for x in ics(6, b=500))
    Q1, P1 = cs.rollout_in_kernel(one, q0, p0, 50, loss_check=True)
    for pm in (split1, twice):
        Q, P = cs.rollout_in_kernel(pm, q0, p0, 50, loss_check=True)
        assert torch.equal(Q.view(torch.int32), Q1.view(torch.int32))
        assert torch.equal(P.view(torch.int32), P1.view(torch.int32))


# --- the explicit update, Algorithm 2 and mod_p / pdiff ---------------------

# mode -> (kernel, rollout keywords, mod_p); the wrap modes start the
# orbits at P across 0, where the wrap sends them near 2 pi
NEW_MODES = {
    "explicit": ("per_se", dict(explicit=True), None),
    "explicit_se_se": ("se_se", dict(explicit=True), None),
    "sum": ("sum_per_se", {}, None),
    "implicit_wrap": ("per_se", dict(track_pdiff=True), 2 * math.pi),
    "explicit_wrap": ("per_se_freq", dict(explicit=True, track_pdiff=True),
                      2 * math.pi),
    "sum_wrap": ("sum_per_se", dict(track_pdiff=True), 2 * math.pi),
}


def _mode_models(mode, n, dtype, device):
    """Toy models of the mode's kernel on ``n`` points (an aux GP for the
    implicit map only), packed over exactly ``n``, and its keywords."""
    name, kw, mod_p = NEW_MODES[mode]
    X, z, Xp, zp = toy_data(n, seed=1)
    na = min(n, AUX_POINTS)
    k = kv.get_kernel(name)
    params = [0.9, 1.2, 0.55][: k.n_params]
    f64 = dict(dtype=torch.float64, device=device)
    sgp = SympGP.create(k, params, 1.5, 1e-2, torch.tensor(X, **f64), z)
    aux = (AuxGP.create(k, params, 1.5, 1e-2, torch.tensor(Xp[:na], **f64),
                        zp[:na]) if mode.startswith("implicit") else None)
    pm = cs.pack_models(sgp, aux, mod_q=2 * math.pi, mod_p=mod_p,
                        dtype=dtype)
    return _truncated(pm, n), kw


def _mode_ics(mode, dtype, device, b, seed=2):
    q0, p0 = (torch.tensor(x, dtype=dtype, device=device)
              for x in ics(seed, b=b))
    return q0, (p0 * 2 if NEW_MODES[mode][2] else p0.abs())


@pytest.mark.parametrize("mode", list(NEW_MODES))
@pytest.mark.parametrize("team,n", TEAMS_F64)
def test_new_modes_forced_team_float64(cuda, mode, team, n):
    """Every team size in each new mode against the plain version: 1e-9
    over 100 steps (pdiff too), the same NaN pattern; the loss check at
    the old q in the modes without the wrap."""
    pm, kw = _mode_models(mode, n, torch.float64, cuda)
    q0, p0 = _mode_ics(mode, torch.float64, cuda, 77)
    loss = pm.mod_p is None
    before = launch_counts()["rollout"]
    got = cs._launch(pm, q0, p0, 100, 5, loss_check=loss, team=team, **kw)
    assert launch_counts()["rollout"] == before + 1
    ref = cs.rollout_reference(pm, q0, p0, 100, loss_check=loss, **kw)
    assert len(got) == len(ref) == (3 if kw.get("track_pdiff") else 2)
    for g, r in zip(got, ref):
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        assert _diff(g, r) <= 1e-9
    if pm.mod_p:
        P = got[1][1:]
        assert float(P.min()) >= 0 and float(P.max()) <= 2 * math.pi
        assert float((got[2] - got[1]).abs().max()) > 6  # some wrapped


@pytest.mark.parametrize("mode", list(NEW_MODES))
@pytest.mark.parametrize("team,n", TEAMS + TEAMS_LARGE)
def test_new_modes_forced_team_float32(cuda, mode, team, n):
    """float32 at steps 1-2, the same NaN pattern: up to 100 points at
    1e-4 (as test_kernel_forced_team_float32); from 1000 on the sums carry
    more float32 rounding than that (Algorithm 2 at team 256: 1.08e-4 on
    an H100; the sum kernel's |alpha| is ~30x the product kernel's), so
    there both are held against the float64 rollout of the same float32
    columns, the kernel's L2 error within 3x the plain version's, as
    test_kernel_forced_team_float32_large_n; the wrapped Q and P on their
    circles.  TEAMS_LARGE runs the instances that hold 16 points a lane
    at thousands of points, as standard_map_large's rollout at N=4096;
    there the float32 P carries ~3e-4 of rounding, so an orbit that the
    float64 rollout puts within 3x the plain version's P error of the
    loss boundary may be lost a step apart in the two (on an H100, one
    orbit of 301 at 8000 points, 1.4e-4 below P = 0): the NaN patterns
    are held on the other orbits, which must be at least 98 %."""
    pm, kw = _mode_models(mode, n, torch.float32, cuda)
    q0, p0 = _mode_ics(mode, torch.float32, cuda, 301, seed=3)
    loss = pm.mod_p is None
    got = cs._launch(pm, q0, p0, 3, 5, loss_check=loss, team=team, **kw)
    ref = cs.rollout_reference(pm, q0, p0, 3, loss_check=loss, **kw)
    if n <= 100:
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(npy(torch.isnan(g)),
                                          npy(torch.isnan(r)))
        assert max(_diff(g[1:3], r[1:3]) for g, r in zip(got, ref)) <= 1e-4
        return
    exact = dataclasses.replace(
        pm, **{f: getattr(pm, f).double() for f in (
            "uq", "uP", "a0", "a1", "auxq", "auxp", "auxa", "scal")})
    x = cs.rollout_reference(exact, q0.double(), p0.double(), 3,
                             loss_check=loss, **kw)
    held = torch.ones_like(q0, dtype=torch.bool)
    if loss and (team, n) in TEAMS_LARGE:
        dP = (ref[1][1:3].double() - x[1][1:3]).abs()
        band = 3 * float(dP[~torch.isnan(dP)].max())
        held = ~_near_loss_boundary(exact, q0, p0, kw, band)
        assert int(held.sum()) >= 0.98 * len(held)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(npy(torch.isnan(g[:, held])),
                                      npy(torch.isnan(r[:, held])))

    periods = (2 * math.pi, pm.mod_p, None)

    def err(out) -> float:
        d = torch.cat([_circ(o[1:3].double() - e[1:3], per).reshape(-1)
                       for o, e, per in zip(out, x, periods)])
        return float(d[~torch.isnan(d)].norm())

    assert err(got) <= 3 * err(ref)


def _near_loss_boundary(exact, q0, p0, kw, band):
    """Orbits whose loss at step 1 or 2 the float64 rollout of the
    ``exact`` columns (no loss check) leaves within ``band`` of the
    boundary: the check at the old q decides differently for P - band and
    P + band."""
    Q, P = cs.rollout_reference(exact, q0.double(), p0.double(), 3,
                                **kw)[:2]
    near = torch.zeros_like(q0, dtype=torch.bool)
    for i in (1, 2):
        near |= (cs._tokamak_lost(P[i] - band, Q[i - 1])
                 != cs._tokamak_lost(P[i] + band, Q[i - 1]))
    return near


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["implicit_wrap", "explicit_wrap",
                                  "sum_wrap"])
def test_pdiff_rows_of_lost_orbits(cuda, mode, dtype):
    """The loss check at the old q with pdiff: the kernel flags a lost
    orbit a step late and rewrites its row; D's row is rewritten with Q
    and P, and D stays NaN from there on, as in the plain version.  Orbits
    near P = 0, lost over several steps; teams of 8 share warps."""
    pm, kw = _mode_models(mode, 40, dtype, cuda)
    q0, p0 = _mode_ics(mode, dtype, cuda, 64, seed=4)
    p0 = p0.abs() * 0.3
    Q, P, D = cs._launch(pm, q0, p0, 60, 5, loss_check=True, team=8, **kw)
    Qr, Pr, Dr = cs.rollout_reference(pm, q0, p0, 60, loss_check=True, **kw)
    lost = torch.isnan(Pr)
    first = lost.float().argmax(0)[lost[-1]]  # step each lost orbit is lost
    assert 0 < int(lost[-1].sum()) < 64 and int(first.max()) > 10
    assert int(lost[-1].sum()) > int(lost[1].sum())
    for g in (Q, P, D):
        assert torch.equal(torch.isnan(g), lost)
    assert torch.equal(lost, torch.cummax(lost.int(), 0).values.bool())
    steps, atol = (60, 1e-9) if dtype == torch.float64 else (3, 1e-4)
    assert max(_diff(a[:steps], b[:steps])
               for a, b in ((Q, Qr), (P, Pr), (D, Dr))) <= atol


@pytest.mark.parametrize("mode", list(NEW_MODES))
def test_new_modes_bitwise_deterministic(cuda, mode):
    pm, kw = _mode_models(mode, 40, torch.float32, cuda)
    q0, p0 = _mode_ics(mode, torch.float32, cuda, 1000, seed=5)
    a = cs.rollout_in_kernel(pm, q0, p0, 200, **kw)
    b = cs.rollout_in_kernel(pm, q0, p0, 200, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrap_instance_without_mod_p_same_bits(cuda, dtype):
    """pdiff without mod_p runs the implicit wrap instance with the wrap
    off: Q and P to the bit of the implicit instance, which the new modes
    leave as it was, and D the running sum of P's steps (= P here)."""
    sgp, aux = _models("per_se", cuda)
    pm = cs.pack_models(sgp, aux, mod_q=2 * math.pi, dtype=dtype)
    q0, p0 = (torch.tensor(x, dtype=dtype, device=cuda)
              for x in ics(6, b=500))
    Q1, P1 = cs.rollout_in_kernel(pm, q0, p0, 50, loss_check=True)
    Q, P, D = cs.rollout_in_kernel(pm, q0, p0, 50, loss_check=True,
                                   track_pdiff=True)
    it = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(Q.view(it), Q1.view(it))
    assert torch.equal(P.view(it), P1.view(it))
    assert torch.equal(torch.isnan(D), torch.isnan(P))
    assert _diff(D, P) <= (1e-4 if dtype == torch.float32 else 1e-12)


# --- the perturbed pendulum's and Henon-Heiles' instances --------------------

# instance -> (kernel, aux delta, mod_q, coordinate scale): Henon-Heiles'
# SE x SE model with an SE x SE aux model of P - p and no wrap of q, on
# section coordinates scaled to |q|, |P| up to ~15; the perturbed
# pendulum's periodic model with an aux model of the absolute P
WORKLOAD_INSTANCES = {
    "henon_se_se_no_wrap": ("se_se", True, None, 12.0),
    "pert_absolute_aux": ("per_se", False, 2 * math.pi, 1.0),
}


def _workload_models(case, n, dtype, device):
    """Seeded toy models of the instance on ``n`` points and its ICs."""
    name, delta, mod_q, scale = WORKLOAD_INSTANCES[case]
    rng = np.random.default_rng(n)
    lo, hi = (-scale, scale) if mod_q is None else (0.0, 2 * math.pi)
    q = rng.uniform(lo, hi, n)
    P = rng.uniform(-scale, scale, n)
    p = P + 0.05 * scale * np.sin(q / scale)
    z = np.concatenate([p - P, 0.05 * scale * np.cos(q / scale)
                        + 0.02 * P])
    zp = P if not delta else P - p
    params = [0.5 * scale + 0.4, 0.5 * scale + 0.7]
    f64 = dict(dtype=torch.float64, device=device)
    k = kv.get_kernel(name)
    sgp = SympGP.create(k, params, 1.5, 1e-2,
                        torch.tensor(np.stack([q, P], 1), **f64), z)
    aux = AuxGP.create(k, params, 1.5, 1e-2,
                       torch.tensor(np.stack([q, p], 1), **f64), zp,
                       delta=delta)
    pm = cs.pack_models(sgp, aux, mod_q=mod_q, dtype=dtype)
    q0 = torch.tensor(rng.uniform(0.8 * lo, 0.8 * hi, 150), dtype=dtype,
                      device=device)
    p0 = torch.tensor(rng.uniform(-0.8 * scale, 0.8 * scale, 150),
                      dtype=dtype, device=device)
    return pm, q0, p0, scale


@pytest.mark.parametrize("case", list(WORKLOAD_INSTANCES))
@pytest.mark.parametrize("n", [20, 60])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_workload_instances_match_reference(cuda, case, n, dtype):
    """The two workloads' new instances against the plain version: float64
    every step of 100 at 1e-9 relative to the coordinates' scale, float32
    at steps 1-2 at 2e-5 of it; the same NaN pattern (none lost: no loss
    check), q left unwrapped without mod_q."""
    pm, q0, p0, scale = _workload_models(case, n, dtype, cuda)
    assert pm.kind == pm.aux_kind and pm.delta == (pm.mod_q is None)
    nm = 100 if dtype == torch.float64 else 3
    before = launch_counts()["rollout"]
    got = cs.rollout_in_kernel(pm, q0, p0, nm)
    assert launch_counts()["rollout"] == before + 1
    ref = cs.rollout_reference(pm, q0, p0, nm)
    atol = (1e-9 if dtype == torch.float64 else 2e-5) * scale
    for g, r in zip(got, ref):
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        assert bool(torch.isfinite(g).all())
        assert _diff(g[:3], r[:3]) <= atol
        assert _diff(g, r) <= (atol if dtype == torch.float64 else math.inf)
    if pm.mod_q is None:  # orbits leave [0, 2 pi) on both sides
        assert float(got[0].min()) < 0
    else:
        # float32 rounds the top of [0, 2 pi) to fl32(2 pi)
        assert 0 <= float(got[0].min())
        assert float(got[0].max()) <= float(np.float32(2 * math.pi))
