"""PyTorch port vs JAX: packing for the fused rollout and the kernel's
plain version ``rollout_reference`` against the Pallas kernel (interpret
mode on the CPU, as ``tests/test_pallas_step.py`` runs it).

float32 orbits decohere between any two summation orders within tens of
steps, so float32 trajectories are compared at steps 1-4 with the
tolerances of ``tests/test_pallas_step.py`` (2e-5 after one step, 5e-4
after three).  The kernel itself needs a card: ``test_torch_cuda_kernel.py``.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import ics, jax_models_to_port, npy, tt, toy_data  # noqa: E402,E501

from sympgpr_tpu.gp.model import AuxGP, SympGP  # noqa: E402
from sympgpr_tpu.kernels import variants as jvar  # noqa: E402
from sympgpr_tpu.maps import fast_apply as jfa  # noqa: E402
from sympgpr_tpu.maps.symplectic import MapConfig as JCfg  # noqa: E402
from sympgpr_tpu.ops import pallas_step as ps  # noqa: E402
from sympgpr_tpu.systems.tokamak import TokamakConfig as JTok  # noqa: E402
from sympgpr_tpu.workloads.tokamak import make_loss_fn as jloss  # noqa: E402
from sympgpr_tpu_torch.ops import cuda_step as cs  # noqa: E402

PRODUCT = ["per_se", "se_se", "per_se_freq"]


def f32_models(name, n=20, seed=0):
    """The well-conditioned float32 toys of tests/test_pallas_step.py:
    smooth targets and jitter 1e-2 keep |alpha| ~ O(1)."""
    X, z, Xp, zp = toy_data(n, seed)
    k = jvar.get_kernel(name)
    params = jnp.asarray([0.9, 1.2, 0.55][: k.n_params], jnp.float32)
    sgp = SympGP.create(k, params, 1.5, 1e-2, jnp.asarray(X, jnp.float32),
                        jnp.asarray(z, jnp.float32))
    aux = AuxGP.create(k, params, 1.5, 1e-2, jnp.asarray(Xp, jnp.float32),
                       jnp.asarray(zp, jnp.float32), delta=True)
    return sgp, aux


def f32(x):
    return tt(x, torch.float32)


@pytest.mark.parametrize("name", PRODUCT)
def test_pack_models_matches_jax(name):
    sgp, aux = f32_models(name, n=20)
    pj = ps.pack_models(sgp, aux, mod_q=2 * np.pi)
    ts, ta = jax_models_to_port(sgp, aux)
    pt = cs.pack_models(ts, ta, mod_q=2 * np.pi)
    assert (pt.kind, pt.aux_kind, pt.ns, pt.nas) == (
        pj.kind, pj.aux_kind, pj.ns, pj.nas)
    assert pt.ns == 24  # padded 20 -> 24
    for f in ("uq", "uP", "a0", "a1", "auxq", "auxp", "auxa"):
        a, b = npy(getattr(pt, f)), np.asarray(getattr(pj, f))[:, 0]
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(npy(pt.scal), np.asarray(pj.scal))


def test_pack_models_float64_and_no_aux():
    X, z, _, _ = toy_data(13, seed=2)
    sgp = SympGP.create(jvar.PER_SE, jnp.asarray([0.9, 1.2]), 1.5, 1e-4,
                        jnp.asarray(X), jnp.asarray(z))
    pj = ps.pack_models(sgp, None, mod_q=None)
    ts, _ = jax_models_to_port(sgp, None)
    pt = cs.pack_models(ts, None, mod_q=None, dtype=torch.float64)
    assert pt.uq.dtype == torch.float64 and pt.nas == 8 and not pt.delta
    al = np.asarray(sgp.alpha).reshape(2, 13) * float(sgp.sig)
    np.testing.assert_array_equal(npy(pt.a0)[:13], al[0])
    np.testing.assert_array_equal(npy(pt.a0)[13:], 0.0)
    np.testing.assert_array_equal(npy(pt.auxa), 0.0)
    np.testing.assert_array_equal(npy(pt.scal).astype(np.float32),
                                  np.asarray(pj.scal))


@pytest.mark.parametrize("name", PRODUCT)
def test_reference_one_step_matches_pallas(name):
    sgp, aux = f32_models(name)
    ts, ta = jax_models_to_port(sgp, aux)
    q0, p0 = ics(1)
    pj = ps.pack_models(sgp, aux, mod_q=None)
    Qj, Pj = ps.rollout_in_kernel(pj, jnp.asarray(q0, jnp.float32),
                                  jnp.asarray(p0, jnp.float32), 2, iters=8,
                                  loss_check=True, interpret=True)
    pt = cs.pack_models(ts, ta, mod_q=None)
    Qt, Pt = cs.rollout_reference(pt, f32(q0), f32(p0), 2, iters=8,
                                  loss_check=True)
    assert Qt.shape == (2, 128) and Qt.dtype == torch.float32
    assert 0 < np.isnan(npy(Pt[1])).sum() < 128  # P < 0 orbits are lost
    np.testing.assert_array_equal(npy(Qt[0]), np.float32(q0))
    np.testing.assert_allclose(npy(Pt[1]), np.asarray(Pj[1]), atol=2e-5)
    np.testing.assert_allclose(npy(Qt[1]), np.asarray(Qj[1]), atol=2e-5)


def test_reference_multi_step_matches_pallas():
    sgp, aux = f32_models("per_se", seed=2)
    ts, ta = jax_models_to_port(sgp, aux)
    q0, p0 = ics(2)
    p0 = np.abs(p0)  # keep orbits alive for the whole horizon
    nm = 4
    pj = ps.pack_models(sgp, aux, mod_q=2 * np.pi)
    Qj, Pj = ps.rollout_in_kernel(pj, jnp.asarray(q0, jnp.float32),
                                  jnp.asarray(p0, jnp.float32), nm,
                                  loss_check=True, interpret=True)
    pt = cs.pack_models(ts, ta, mod_q=2 * np.pi)
    Qt, Pt = cs.rollout_in_kernel(pt, f32(q0), f32(p0), nm, loss_check=True)
    for i in range(1, nm):
        np.testing.assert_allclose(npy(Pt[i]), np.asarray(Pj[i]), atol=5e-4)
        np.testing.assert_allclose(npy(Qt[i]), np.asarray(Qj[i]), atol=5e-4)


def test_reference_float64_matches_fast_apply():
    """float64 plain version over the packed columns vs the JAX fast path
    on the unpacked models (sig folded into alpha moves the last digit):
    1e-12 over five steps."""
    X, z, Xp, zp = toy_data(20, seed=3)
    sgp = SympGP.create(jvar.PER_SE, jnp.asarray([0.9, 1.2]), 1.5, 1e-4,
                        jnp.asarray(X), jnp.asarray(z))
    aux = AuxGP.create(jvar.PER_SE, jnp.asarray([0.9, 1.2]), 1.5, 1e-4,
                       jnp.asarray(Xp), jnp.asarray(zp), delta=True)
    q0, p0 = ics(3, b=32)
    ref = jfa.apply_map_fast(sgp, aux, jnp.asarray(q0), jnp.asarray(p0), 6,
                             JCfg(newton_maxiter=5), fixed_iters=True,
                             loss_pre=jloss(JTok(), use_new_q=False))
    ts, ta = jax_models_to_port(sgp, aux)
    pt = cs.pack_models(ts, ta, mod_q=2 * np.pi, dtype=torch.float64)
    Qt, Pt = cs.rollout_reference(pt, tt(q0), tt(p0), 6, iters=5,
                                  loss_check=True)
    np.testing.assert_allclose(npy(Qt), np.asarray(ref.q), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(npy(Pt), np.asarray(ref.p), rtol=1e-12,
                               atol=1e-12)


def test_rollout_in_kernel_cpu_runs_reference():
    sgp, aux = f32_models("per_se", seed=4)
    pt = cs.pack_models(*jax_models_to_port(sgp, aux), mod_q=2 * np.pi)
    q0, p0 = ics(4)
    before = cs.LAUNCHES
    a = cs.rollout_in_kernel(pt, f32(q0), f32(p0), 3, loss_check=True)
    b = cs.rollout_reference(pt, f32(q0), f32(p0), 3, loss_check=True)
    assert cs.LAUNCHES == before  # the CPU path launches no kernel
    for x, y in zip(a, b):
        np.testing.assert_array_equal(npy(x), npy(y))


@pytest.mark.parametrize("mode", ["explicit", "loss_at_new_q", "track_pdiff",
                                  "mod_p", "sum_kernel", "split"])
def test_unsupported_modes_raise(mode):
    sgp, aux = f32_models("sum_per_se" if mode == "sum_kernel" else "per_se")
    ts, ta = jax_models_to_port(sgp, aux)
    pm = cs.pack_models(ts, ta, mod_q=2 * np.pi,
                        mod_p=2 * np.pi if mode == "mod_p" else None)
    kw = {m: True for m in ("explicit", "loss_at_new_q", "track_pdiff")
          if m == mode}
    q0, p0 = ics(5, b=8)
    with pytest.raises(NotImplementedError, match="does not cover"):
        if mode == "split":
            cs.rollout_model([ts, ts], [ta, ta], f32(q0), f32(p0), 2)
        else:
            cs.rollout_in_kernel(pm, f32(q0), f32(p0), 2, **kw)


def test_validate_rejects_bad_inputs():
    sgp, aux = f32_models("per_se")
    pm = cs.pack_models(*jax_models_to_port(sgp, aux), mod_q=2 * np.pi)
    q0, p0 = f32(ics(6, b=8)[0]), f32(ics(6, b=8)[1])
    cs._validate(pm, q0, p0, 3, 5)  # accepted
    with pytest.raises(ValueError, match="float32"):
        cs._validate(pm, q0.double(), p0.double(), 3, 5)
    with pytest.raises(TypeError):
        cs._validate(pm, q0.half(), p0.half(), 3, 5)
    with pytest.raises(ValueError, match="1-D"):
        cs._validate(pm, q0[:4], p0, 3, 5)
    with pytest.raises(ValueError, match="contiguous"):
        cs._validate(pm, torch.stack([q0, q0], 1)[:, 0], p0, 3, 5)
    with pytest.raises(ValueError, match="nm"):
        cs._validate(pm, q0, p0, 0, 5)
    # float32 and float64 at N = 4096 are accepted; one lane holds at most
    # P_MAX points of a team of at most team_max lanes, so more raise (and
    # so does anything beyond 1024 lanes' worth)
    pm64 = cs.pack_models(*jax_models_to_port(sgp, aux), mod_q=2 * np.pi,
                          dtype=torch.float64)
    for p, q, pp in ((pm, q0, p0), (pm64, q0.double(), p0.double())):
        geo = cs._validate(dataclasses.replace(p, ns=4096, nas=512), q,
                           pp, 3, 5)
        assert geo.team * geo.per_lane >= 4096
        assert geo.per_lane <= cs.P_MAX
        assert cs.ns_max(q.dtype) == cs.team_max(q.dtype) * cs.P_MAX >= 4096
        for ns in (cs.ns_max(q.dtype) + 8, 1024 * cs.P_MAX + 8):
            with pytest.raises(ValueError, match="at most [0-9]+ training"):
                cs._validate(dataclasses.replace(p, ns=ns), q, pp, 3, 5)
        # the aux table must fit a block's shared memory
        with pytest.raises(ValueError, match="shared memory"):
            cs._validate(dataclasses.replace(p, nas=60000), q, pp, 3, 5)
    with pytest.raises(ValueError, match="power of two"):
        cs._validate(pm, q0, p0, 3, 5, team=12)


GEOMETRY_CASES = [  # B, ns, nas: the main path's shapes and ragged ones
    (32768, 80, 80), (30, 80, 80), (30, 4096, 512), (4096, 4096, 512),
    (1, 8, 8), (7, 37, 13), (300, 1000, 4000), (100000, 4096, 3),
    (5000, 129, 2500), (2, 4095, 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,ns,nas", GEOMETRY_CASES)
def test_launch_geometry(B, ns, nas, dtype):
    g = cs.launch_geometry(B, ns, nas, dtype)
    team_max, max_threads = cs.team_max(dtype), cs.max_threads(dtype)
    assert g.team & (g.team - 1) == 0 and 1 <= g.team <= team_max <= 1024
    assert g.per_lane * g.team >= ns and g.per_lane <= cs.P_MAX
    assert g.per_lane == -(-ns // g.team)
    compute = g.team * g.teams_per_block  # a solver warp follows if room
    assert g.threads == compute + cs.SOLVER_THREADS * (
        compute + cs.SOLVER_THREADS <= max_threads)
    assert g.threads <= max_threads <= 1024
    assert compute <= team_max and compute % 32 == 0
    # the instance: the first (most resident) that holds the lane's points
    # and the block's threads
    instances = cs.INSTANCES[dtype]
    assert g.instance == next(i for i in instances
                              if i[0] >= g.per_lane and i[1] >= g.threads)
    assert max(p for p, _, _ in instances) == cs.P_MAX
    # the narrowest team whose lanes fit an instance that shares its SM,
    # or wider: never so wide that the batch overfills one wave, nor wider
    # than ns needs
    shared = max(p for p, _, blocks in instances if blocks > 1)
    narrowest = min(team_max, 1 << max(0, -(-ns // shared) - 1).bit_length())
    assert g.team >= narrowest
    _, threads, blocks = instances[0]
    fill = cs.SM_COUNT * threads * blocks
    cap = min(cs.FILL_TEAM_MAX,
              1 << max(0, -(-ns // cs.PAIRS[dtype]) - 1).bit_length())
    if g.team > narrowest:
        assert B * (g.team // 2) < fill
    # ... unless a block of twice the team would overflow shared memory
    assert (B * g.team >= fill or g.team >= cap
            or cs.launch_geometry(B, ns, nas, dtype, team=2 * g.team)
            .smem_bytes > cs.SMEM_LIMIT)
    # a small batch spreads one team a block over the SMs
    if B <= cs.SM_COUNT:
        assert compute <= max(32, g.team)
    elt = torch.empty((), dtype=dtype).element_size()
    pairs = cs.PAIRS[dtype]
    records = -(-g.per_lane // pairs) * pairs
    assert g.smem_bytes == (4 * nas + 4 * compute // 32
                            + 6 * g.teams_per_block
                            + (cs.FIELDS * records + 1) * compute) * elt
    assert g.smem_bytes <= cs.SMEM_LIMIT


def test_launch_geometry_forced_team():
    g = cs.launch_geometry(77, 37, 13, torch.float32, team=8)
    assert (g.team, g.per_lane, g.teams_per_block, g.threads) == (8, 5, 4, 64)
    assert g.instance == (10, 288, 3)
    assert cs.launch_geometry(77, 6, 6, torch.float64, team=1).threads == 64
    for bad in (0, 3, 1024, 1):  # 1 lane cannot hold 37 points
        with pytest.raises(ValueError, match="power of two"):
            cs.launch_geometry(77, 37, 13, torch.float32, team=bad)
    # float32's 512-lane team runs without a solver warp; float64's widest
    # team is 256 lanes, with one
    g = cs.launch_geometry(3, 1000, 1000, torch.float32, team=512)
    assert (g.threads, g.per_lane, g.instance) == (512, 2, (10, 512, 1))
    g = cs.launch_geometry(3, 1000, 1000, torch.float64, team=256)
    assert (g.threads, g.instance) == (288, (8, 288, 2))
    with pytest.raises(ValueError, match="power of two <= 256"):
        cs.launch_geometry(3, 1000, 1000, torch.float64, team=512)
    # a row holds the lane's own points, not the instance's: 256 lanes of
    # 4 points and a 1000-point aux table fit a float64 block
    assert g.smem_bytes <= cs.SMEM_LIMIT
    # lanes of more than 10 (float32) or 8 (float64) points take the
    # instances that hold 16; float32's 512-lane team its 512-thread one
    assert cs.launch_geometry(30, 4096, 512, torch.float32).instance == \
        (16, 288, 2)
    assert cs.launch_geometry(30, 4096, 512, torch.float64).instance == \
        (16, 288, 1)
    assert cs.launch_geometry(30, 100, 100, torch.float64,
                              team=8).instance == (16, 288, 1)
    assert cs.launch_geometry(30, 8192, 512, torch.float32).instance == \
        (16, 512, 1)


def test_rollout_model_matches_rollout_pallas():
    """Model level: float64 models, deployment jitter, float32 rollout.

    The deployment jitter (1e-3 of max diag K) leaves |alpha| ~10, larger
    than in the 1e-2 toys, so the float32 posterior sums carry more
    summation-order noise: 5e-5 after one step."""
    X, z, Xp, zp = toy_data(24, seed=6)
    sgp = SympGP.create(jvar.PER_SE, jnp.asarray([0.9, 1.2]), 1.5, 1e-8,
                        jnp.asarray(X), jnp.asarray(z))
    aux = AuxGP.create(jvar.PER_SE, jnp.asarray([0.9, 1.2]), 1.5, 1e-8,
                       jnp.asarray(Xp), jnp.asarray(zp), delta=True)
    q0, p0 = ics(6, b=40)
    p0 = np.abs(p0)
    Qj, Pj = ps.rollout_pallas(sgp, aux, jnp.asarray(q0), jnp.asarray(p0), 3,
                               loss_check=True)
    ts, ta = jax_models_to_port(sgp, aux)
    Qt, Pt = cs.rollout_model(ts, ta, tt(q0), tt(p0), 3, loss_check=True)
    assert Qt.shape == (3, 40) and Qt.dtype == torch.float32
    np.testing.assert_allclose(npy(Pt[1]), np.asarray(Pj[1]), atol=5e-5)
    np.testing.assert_allclose(npy(Qt[1]), np.asarray(Qj[1]), atol=5e-5)
    with pytest.raises(ValueError, match="initial conditions"):
        cs.rollout_model(ts, ta, tt(q0, device="meta"), tt(p0), 3)
