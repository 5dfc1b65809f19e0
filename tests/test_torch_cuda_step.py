"""PyTorch port vs JAX: packing for the fused rollout and the kernel's
plain version ``rollout_reference`` against the Pallas kernel (interpret
mode on the CPU, as ``tests/test_pallas_step.py`` runs it).

float32 orbits decohere between any two summation orders within tens of
steps, so float32 trajectories are compared at steps 1-4 with the
tolerances of ``tests/test_pallas_step.py`` (2e-5 after one step, 5e-4
after three), the explicit update, Algorithm 2 and mod_p / pdiff
included.  Split cycling and the loss check at the new q:
``test_torch_split.py``; with the explicit update, Algorithm 2 and mod_p
/ pdiff: ``test_torch_split_modes.py``.  The kernel itself needs a card:
``test_torch_cuda_kernel.py``.
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
from sympgpr_tpu_torch.profiling import launch_counts  # noqa: E402

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
    before = launch_counts()["rollout"]
    a = cs.rollout_in_kernel(pt, f32(q0), f32(p0), 3, loss_check=True)
    b = cs.rollout_reference(pt, f32(q0), f32(p0), 3, loss_check=True)
    assert launch_counts()["rollout"] == before  # the CPU path: no kernel
    for x, y in zip(a, b):
        np.testing.assert_array_equal(npy(x), npy(y))


@pytest.mark.parametrize("mode", ["explicit", "track_pdiff", "mod_p",
                                  "sum_kernel"])
def test_split_modes_run_where_jax_runs(mode):
    """The explicit update, Algorithm 2 and mod_p / pdiff with Split
    cycling (two sub-maps) or the loss check at the new q: the Pallas
    kernel returns trajectories, and so do the kernel's wrapper and its
    plain version on the CPU, of the same shape and arity and equal to
    JAX's at row 1 within 5e-4 (the cases themselves, at their own
    tolerances: test_torch_split_modes.py)."""
    sgp, aux = f32_models("sum_per_se" if mode == "sum_kernel" else "per_se")
    ts, ta = jax_models_to_port(sgp, aux)
    mod_p = 2 * np.pi if mode == "mod_p" else None
    kw = {m: True for m in ("explicit", "track_pdiff") if m == mode}
    q0, p0 = ics(5)
    for n_maps, new_q in ((2, False), (1, True)):
        pj = ps.pack_models_split([sgp] * n_maps, [aux] * n_maps,
                                  mod_q=2 * np.pi, mod_p=mod_p)
        pt = cs.pack_models_split([ts] * n_maps, [ta] * n_maps,
                                  mod_q=2 * np.pi, mod_p=mod_p)
        outj = ps.rollout_in_kernel(pj, jnp.asarray(q0, jnp.float32),
                                    jnp.asarray(p0, jnp.float32), 2,
                                    loss_check=new_q, loss_at_new_q=new_q,
                                    interpret=True, **kw)
        for call in (cs.rollout_in_kernel, cs.rollout_reference):
            out = call(pt, f32(q0), f32(p0), 2, 5, new_q,
                       loss_at_new_q=new_q, **kw)
            assert len(out) == len(outj) == (3 if mode == "track_pdiff"
                                             else 2)
            for a, b in zip(out, outj):
                assert a.shape == b.shape == (2, 128)
                np.testing.assert_allclose(npy(a[1]), np.asarray(b[1]),
                                           atol=5e-4)


# --- the explicit update, Algorithm 2 and mod_p / pdiff ----------------------
# (the cases of tests/test_pallas_step.py, with its tolerances)


@pytest.mark.parametrize("name", PRODUCT)
def test_reference_explicit_product_matches_pallas(name):
    """Explicit product update P = p - pGP(q, p): no Newton, no aux."""
    sgp, aux = f32_models(name, seed=7)
    q0, p0 = ics(7)
    pj = ps.pack_models(sgp, aux, mod_q=2 * np.pi)
    Qj, Pj = ps.rollout_in_kernel(pj, jnp.asarray(q0, jnp.float32),
                                  jnp.asarray(p0, jnp.float32), 2,
                                  explicit=True, interpret=True)
    pt = cs.pack_models(*jax_models_to_port(sgp, aux), mod_q=2 * np.pi)
    Qt, Pt = cs.rollout_reference(pt, f32(q0), f32(p0), 2, explicit=True)
    np.testing.assert_allclose(npy(Pt[1]), np.asarray(Pj[1]), atol=2e-5)
    np.testing.assert_allclose(npy(Qt[1]), np.asarray(Qj[1]), atol=2e-5)
    # the implicit map lands elsewhere: the flag is taken
    _, Pi = cs.rollout_reference(pt, f32(q0), f32(p0), 2)
    assert float((Pi[1] - Pt[1]).abs().max()) > 1e-3


def test_reference_sum_kernel_algorithm2_matches_pallas():
    """sum_per_se: Algorithm 2 without asking (kind 3 implies explicit),
    no aux model, three steps."""
    sgp, _ = f32_models("sum_per_se", seed=4)
    q0, p0 = ics(4)
    pj = ps.pack_models(sgp, None, mod_q=2 * np.pi)
    Qj, Pj = ps.rollout_in_kernel(pj, jnp.asarray(q0, jnp.float32),
                                  jnp.asarray(p0, jnp.float32), 3,
                                  interpret=True)
    pt = cs.pack_models(*jax_models_to_port(sgp, None), mod_q=2 * np.pi)
    assert pt.kind == 3 and float(pt.scal[0, 6]) == 0.0
    Qt, Pt = cs.rollout_in_kernel(pt, f32(q0), f32(p0), 3)
    for i in (1, 2):
        np.testing.assert_allclose(npy(Pt[i]), np.asarray(Pj[i]), atol=5e-5)
        np.testing.assert_allclose(npy(Qt[i]), np.asarray(Qj[i]), atol=5e-5)


@pytest.mark.parametrize("loss_check", [False, True])
def test_reference_mod_p_and_pdiff_matches_pallas(loss_check):
    """mod_p wrap with the unwrapped momentum as a third output (row 0 =
    p0), the standard map's mode; with the loss check at the old q a lost
    orbit's pdiff is NaN from its row on."""
    sgp, aux = f32_models("per_se", seed=8)
    q0, p0 = ics(8)
    p0 = p0 * 8 + 3.0  # P crosses 0 and 2 pi
    mod_p = 2 * np.pi
    pj = ps.pack_models(sgp, aux, mod_q=2 * np.pi, mod_p=mod_p)
    Qj, Pj, Dj = ps.rollout_in_kernel(
        pj, jnp.asarray(q0, jnp.float32), jnp.asarray(p0, jnp.float32), 4,
        loss_check=loss_check, track_pdiff=True, interpret=True)
    pt = cs.pack_models(*jax_models_to_port(sgp, aux), mod_q=2 * np.pi,
                        mod_p=mod_p)
    Qt, Pt, Dt = cs.rollout_in_kernel(pt, f32(q0), f32(p0), 4,
                                      loss_check=loss_check,
                                      track_pdiff=True)
    np.testing.assert_array_equal(npy(Dt[0]), np.float32(p0))
    P = npy(Pt[1:])
    assert np.nanmin(P) >= 0 and np.nanmax(P) <= np.float32(mod_p)
    assert np.nanmax(np.abs(npy(Dt) - npy(Pt))) > 6  # some orbits wrapped
    lost = np.isnan(npy(Pt))
    assert (lost.any() and not lost.all()) == loss_check
    np.testing.assert_array_equal(np.isnan(npy(Dt)), lost)
    for i in range(1, 4):
        for a, b in ((Pt, Pj), (Qt, Qj), (Dt, Dj)):
            np.testing.assert_allclose(npy(a[i]), np.asarray(b[i]),
                                       atol=5e-4)


@pytest.mark.parametrize("mode", ["explicit", "sum", "implicit_pdiff"])
def test_reference_new_modes_float64_match_fast_apply(mode):
    """float64 plain version over the packed columns against the JAX fast
    path on the unpacked models: 1e-12 over six steps, the wrap into
    [0, 2 pi) and pdiff included (the sum kernel's |alpha| is ~30x the
    product kernel's at this jitter, and sig folded into it moves the last
    digit by as much: 5e-12 there)."""
    X, z, Xp, zp = toy_data(20, seed=3)
    k = jvar.SUM_PER_SE if mode == "sum" else jvar.PER_SE
    sgp = SympGP.create(k, jnp.asarray([0.9, 1.2]), 1.5, 1e-4,
                        jnp.asarray(X), jnp.asarray(z))
    aux = None if mode != "implicit_pdiff" else AuxGP.create(
        k, jnp.asarray([0.9, 1.2]), 1.5, 1e-4, jnp.asarray(Xp),
        jnp.asarray(zp), delta=True)
    q0, p0 = ics(3, b=32)
    p0 = p0 * 8 + 3.0
    cfg = JCfg(explicit=mode != "implicit_pdiff", mod_p=2 * np.pi,
               track_pdiff=True, newton_maxiter=5)
    ref = jfa.apply_map_fast(sgp, aux, jnp.asarray(q0), jnp.asarray(p0), 6,
                             cfg, fixed_iters=True)
    pt = cs.pack_models(*jax_models_to_port(sgp, aux), mod_q=2 * np.pi,
                        mod_p=2 * np.pi, dtype=torch.float64)
    got = cs.rollout_reference(pt, tt(q0), tt(p0), 6, iters=5,
                               explicit=mode == "explicit",
                               track_pdiff=True)
    tol = 5e-12 if mode == "sum" else 1e-12
    for a, b in zip(got, (ref.q, ref.p, ref.pdiff)):
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=tol,
                                   atol=tol)


def test_rollout_model_mod_p_matches_rollout_pallas():
    """Model level, the standard map's call: mod_q = mod_p = 2 pi, pdiff,
    8 Newton iterations, float32 (negative P wraps to near 2 pi); and the
    sum kernel's, which returns (Q, P).  Deployment jitter 1e-3, as
    test_rollout_model_matches_rollout_pallas (the standard map's 1e-5 in
    test_torch_standard_map.py)."""
    X, z, Xp, zp = toy_data(24, seed=6)
    sgp = SympGP.create(jvar.PER_SE, jnp.asarray([0.9, 1.2]), 1.5, 1e-8,
                        jnp.asarray(X), jnp.asarray(z))
    aux = AuxGP.create(jvar.PER_SE, jnp.asarray([0.9, 1.2]), 1.5, 1e-8,
                       jnp.asarray(Xp), jnp.asarray(zp), delta=True)
    q0, p0 = ics(6, b=40)
    kw = dict(mod_q=2 * np.pi, mod_p=2 * np.pi, track_pdiff=True, iters=8,
              deployment_jitter=1e-3)
    outj = ps.rollout_pallas(sgp, aux, jnp.asarray(q0), jnp.asarray(p0), 3,
                             **kw)
    ts, ta = jax_models_to_port(sgp, aux)
    outt = cs.rollout_model(ts, ta, tt(q0), tt(p0), 3, **kw)
    assert len(outt) == 3 and outt[2].dtype == torch.float32
    assert float(outt[1][1].max()) > 5.0  # wrapped
    for a, b in zip(outt, outj):
        np.testing.assert_allclose(npy(a[1]), np.asarray(b[1]), atol=5e-5)
    s2 = SympGP.create(jvar.SUM_PER_SE, jnp.asarray([0.9, 1.2]), 1.5, 1e-8,
                       jnp.asarray(X), jnp.asarray(z))
    Qj, Pj = ps.rollout_pallas(s2, None, jnp.asarray(q0), jnp.asarray(p0),
                               3, deployment_jitter=1e-3)
    Qt, Pt = cs.rollout_model(jax_models_to_port(s2, None)[0], None, tt(q0),
                              tt(p0), 3, deployment_jitter=1e-3)
    np.testing.assert_allclose(npy(Pt[1]), np.asarray(Pj[1]), atol=5e-5)
    np.testing.assert_allclose(npy(Qt[1]), np.asarray(Qj[1]), atol=5e-5)


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
        assert geo.team * geo.cluster * geo.per_lane >= 4096  # all lanes
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
    """The one-block layout (``cluster=1``) by its rules, then the
    cluster the rule adds to it where a small batch leaves SMs idle."""
    _cluster_rule(cs.launch_geometry(B, ns, nas, dtype), B, ns, nas, dtype)
    g = cs.launch_geometry(B, ns, nas, dtype, cluster=1)
    assert g.cluster == 1
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


def _cluster_rule(g, B, ns, nas, dtype):
    """``g`` is the one-block layout, or the cluster team the rule puts
    in its place where the one-block team is FILL_TEAM_MAX lanes or more
    of more than CLUSTER_MIN_POINTS points: the fewest blocks of
    FILL_TEAM_MAX lanes (a power of two C, 2 <= C <= CLUSTER_MAX) whose
    lanes hold at most CLUSTER_POINTS[dtype] points, halved while B C >
    SM_COUNT, whose lanes fit a cluster instance."""
    one = cs.launch_geometry(B, ns, nas, dtype, cluster=1)

    def lanes(c):
        return -(-ns // (cs.FILL_TEAM_MAX * c))

    c = next(c for c in (2, 4, 8) if c == cs.CLUSTER_MAX
             or lanes(c) <= cs.CLUSTER_POINTS[dtype])
    while c > 1 and B * c > cs.SM_COUNT:
        c //= 2
    fits = c > 1 and lanes(c) <= cs.CLUSTER_INSTANCES[-1][0]
    if (one.team < cs.FILL_TEAM_MAX or one.per_lane <= cs.CLUSTER_MIN_POINTS
            or not fits):
        assert g == one
        return
    elt = torch.empty((), dtype=dtype).element_size()
    per_lane = -(-ns // (cs.FILL_TEAM_MAX * c))
    inst = next(i for i in cs.CLUSTER_INSTANCES if i[0] >= per_lane)
    records = inst[0]  # a cluster instance's rows hold all its points
    compute = cs.FILL_TEAM_MAX
    assert (g.cluster, g.team, g.per_lane, g.teams_per_block, g.threads,
            g.instance) == (c, compute, per_lane, 1,
                            compute + cs.SOLVER_THREADS, inst)
    assert g.smem_bytes == (4 * nas + 4 * compute // 32 + 6
                            + (cs.FIELDS * records + 1) * compute) * elt
    assert g.smem_bytes <= min(one.smem_bytes, cs.SMEM_LIMIT)
    assert B * g.cluster <= cs.SM_COUNT


CLUSTER_CASES = [  # B, ns, nas, dtype, keywords, cluster; the parent's
    # one-block layout (team, teams a block, threads, shared memory,
    # instance) where the cluster is 1, else the points of a lane
    (30, 4096, 512, torch.float32, {}, 2, 8),
    (30, 4096, 512, torch.float64, {}, 4, 4),
    (32768, 80, 80, torch.float32, {}, 1, (8, 32, 288, 64640, (10, 288, 3))),
    (30, 80, 80, torch.float32, {}, 1, (64, 1, 96, 4664, (10, 288, 3))),
    (4096, 4096, 512, torch.float32, {}, 1,
     (256, 1, 288, 107672, (16, 288, 2))),
    (37, 55, 55, torch.float64, {}, 1, (64, 1, 96, 5456, (8, 288, 2))),
    (30, 72, 72, torch.float32, {"n_maps": 4}, 1,
     (64, 1, 96, 14328, (10, 288, 3))),
    (30, 4096, 512, torch.float32, {"loss_at_new_q": True}, 1,
     (256, 1, 288, 107720, (16, 288, 2))),
    (30, 4096, 512, torch.float32, {"mode": "implicit_wrap"}, 1,
     (256, 1, 288, 107672, (16, 288, 2))),
    (30, 1024, 512, torch.float32, {}, 1, (256, 1, 288, 33944, (10, 288, 3))),
]


@pytest.mark.parametrize("B,ns,nas,dtype,kw,cluster,parent", CLUSTER_CASES)
def test_launch_geometry_cluster(B, ns, nas, dtype, kw, cluster, parent):
    """The tokamak_large latency shape takes clusters of 2 blocks in
    float32 (60 blocks, lanes of 8 points) and of 4 in float64 (120
    blocks, lanes of 4); the batch shapes, the small-N shapes, the Split,
    new-q and wrap modes and lanes of 4 points keep the parent's
    one-block layout to the byte."""
    g = cs.launch_geometry(B, ns, nas, dtype, **kw)
    assert g.cluster == cluster
    if cluster > 1:
        assert (g.team, g.per_lane) == (256, parent)
        assert g.instance == next(i for i in cs.CLUSTER_INSTANCES
                                  if i[0] >= parent)
        assert g.smem_bytes <= cs.SMEM_LIMIT
        assert B * cluster <= cs.SM_COUNT
        return
    assert (g.team, g.teams_per_block, g.threads, g.smem_bytes,
            g.instance) == parent
    assert g == cs.launch_geometry(B, ns, nas, dtype, cluster=1, **kw)


@pytest.mark.parametrize("kw,match", [
    ({"cluster": 3}, "need 1, 2, 4 or 8"),
    ({"cluster": 16}, "need 1, 2, 4 or 8"),
    ({"cluster": 0}, "need 1, 2, 4 or 8"),
    ({"cluster": 2, "mode": "explicit"}, "implicit one-map"),
    ({"cluster": 4, "n_maps": 2}, "implicit one-map"),
    ({"cluster": 4, "loss_at_new_q": True}, "implicit one-map"),
    ({"cluster": 2, "ns": 8192}, "cluster instance holds 8"),
    ({"cluster": 2, "team": 512, "ns": 8192}, "cluster instance"),
    ({"cluster": 2, "team": 16, "ns": 200}, "at least a warp"),
])
def test_launch_geometry_cluster_forced_invalid(kw, match):
    """A forced cluster the kernel cannot run raises: no power of two up
    to CLUSTER_MAX, a mode without cluster instances, lanes or blocks
    beyond the cluster instance's."""
    args = dict(B=30, ns=kw.pop("ns", 4096), nas=512, dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        cs.launch_geometry(**args, **kw)


@pytest.mark.parametrize("kind,explicit,mod_p,pdiff,mode", [
    (0, False, False, False, "implicit"), (1, False, True, False,
                                           "implicit_wrap"),
    (2, False, False, True, "implicit_wrap"), (0, True, True, True,
                                                "explicit"),
    (3, False, False, False, "sum"), (3, True, True, False, "sum")])
def test_kernel_mode(kind, explicit, mod_p, pdiff, mode):
    assert cs.kernel_mode(kind, explicit, mod_p, pdiff) == mode
    with pytest.raises(ValueError, match="mode"):
        cs.launch_geometry(30, 80, 80, torch.float32, mode="wrap")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,ns,nas,n_maps", [
    (30, 72, 72, 4), (30, 72, 72, 2), (32768, 80, 80, 4), (77, 37, 13, 3),
    (4096, 1024, 512, 2)])
def test_launch_geometry_split(B, ns, nas, n_maps, dtype):
    """Split models: the aux tables of every sub-map, FIELDS_PER_MAP more
    values a point for each further sub-map and a row of NSCAL constants
    per sub-map (the Split instance); the team as with one map unless the
    longer rows would overflow shared memory."""
    g = cs.launch_geometry(B, ns, nas, dtype, n_maps=n_maps)
    one = cs.launch_geometry(B, ns, nas, dtype)
    elt = torch.empty((), dtype=dtype).element_size()
    compute = g.team * g.teams_per_block
    records = -(-g.per_lane // cs.PAIRS[dtype]) * cs.PAIRS[dtype]
    fields = cs.FIELDS + cs.FIELDS_PER_MAP * (n_maps - 1)
    assert g.smem_bytes == (4 * n_maps * nas + 4 * compute // 32
                            + 6 * g.teams_per_block
                            + (fields * records + 1) * compute
                            + cs.NSCAL * n_maps) * elt
    assert g.smem_bytes <= cs.SMEM_LIMIT
    assert g.team <= one.team
    if g.team < one.team:
        assert cs.launch_geometry(B, ns, nas, dtype, team=2 * g.team,
                                  n_maps=n_maps).smem_bytes > cs.SMEM_LIMIT
    with pytest.raises(ValueError, match="n_maps"):
        cs.launch_geometry(B, ns, nas, dtype, n_maps=0)
    # one map checked at the new q runs the Split instance: the table too
    new_q = cs.launch_geometry(B, ns, nas, dtype, loss_at_new_q=True)
    assert new_q.smem_bytes == one.smem_bytes + cs.NSCAL * elt
    assert cs.split_instance(1, True) and not cs.split_instance(1, False)


def test_validate_split_columns():
    """_validate takes the sub-maps' geometry and checks scal's rows."""
    sgp, aux = f32_models("per_se")
    ts, ta = jax_models_to_port(sgp, aux)
    pm = cs.pack_models_split([ts, ts, ts], [ta, ta, ta], mod_q=2 * np.pi)
    q0, p0 = f32(ics(6, b=8)[0]), f32(ics(6, b=8)[1])
    assert cs._validate(pm, q0, p0, 3, 5).smem_bytes == cs.launch_geometry(
        8, pm.ns, pm.nas, torch.float32, n_maps=3).smem_bytes
    with pytest.raises(ValueError, match="sub-map"):
        cs._validate(dataclasses.replace(pm, n_maps=2), q0, p0, 3, 5)


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
    # (in one block: these shapes take cluster teams by default)
    assert cs.launch_geometry(30, 4096, 512, torch.float32,
                              cluster=1).instance == (16, 288, 2)
    assert cs.launch_geometry(30, 4096, 512, torch.float64,
                              cluster=1).instance == (16, 288, 1)
    assert cs.launch_geometry(30, 100, 100, torch.float64,
                              team=8).instance == (16, 288, 1)
    assert cs.launch_geometry(30, 8192, 512, torch.float32,
                              cluster=1).instance == (16, 512, 1)
    # a forced team alone takes no cluster
    assert cs.launch_geometry(30, 4096, 512, torch.float32,
                              team=256).cluster == 1


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
