"""The port's orbit, restart and chain sharding
(``sympgpr_tpu_torch/distributed/sharded.py``, ``gp/hmc.py::
sample_hmc_sharded``, ``gp/nuts.py::sample_nuts_sharded``) on gloo worlds
of 2 and 4 CPU ranks over ``make_mesh`` ((2, 1) and (2, 2): dp = 2 in
both), against the JAX functions on the conftest's CPU mesh with dp = 2,
against the one-process port, and (the samplers, whose JAX threefry
streams torch cannot reproduce) against the per-shard runs."""

import math

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_dist as td  # noqa: E402
from torch_parity import npy  # noqa: E402

WORLDS = [2, 4]
DP = 2  # make_mesh's dp axis at 2 and at 4 ranks


def _jax_models():
    """tests/test_distributed.py's N=6 PER_SE model and its aux model."""
    from sympgpr_tpu.gp.model import AuxGP, SympGP
    from sympgpr_tpu.kernels import PER_SE

    rng = np.random.default_rng(5)
    n = 6
    q = rng.uniform(0, 2 * np.pi, n)
    P = rng.uniform(-1, 1, n)
    X = jnp.asarray(np.stack([q, P], 1))
    z = jnp.asarray(np.concatenate([0.2 * np.sin(q), 0.1 * np.cos(q) * P]))
    sgp = SympGP.create(PER_SE, jnp.array([1.0, 1.0]), 1.0, 1e-10, X, z)
    aux = AuxGP.create(PER_SE, jnp.array([1.0, 1.0]), 1.0, 1e-10, X, z[:n],
                       delta=True)
    return sgp, aux


def _port_models():
    """The same models in the port (the ranks read them from the JAX
    package's artifact)."""
    from torch_parity import jax_models_to_port

    return jax_models_to_port(*_jax_models())


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from sympgpr_tpu.gp.model import save_models

    out = tmp_path_factory.mktemp("dist_sharded")
    path = str(out / "models.npz")
    save_models(path, *_jax_models())
    return {w: td.launch(w, "sharded_cases", out, path) for w in WORLDS}


@pytest.fixture(scope="module")
def jax_refs(worlds):
    from sympgpr_tpu.distributed import sharded
    from sympgpr_tpu.gp.likelihood import nll
    from sympgpr_tpu.kernels import PER_SE
    from sympgpr_tpu.maps import fast_apply
    from sympgpr_tpu.maps.symplectic import MapConfig
    from sympgpr_tpu.ops import pallas_step as ps

    mesh = sharded.make_mesh(jax.devices()[:4])  # (dp, kp) = (2, 2)
    assert mesh.shape["dp"] == DP
    sgp, aux = _jax_models()
    cfg = MapConfig(**td.map_cfg_kw())
    q0, p0 = map(jnp.asarray, td.orbit_ics(td.B_MAP, 1))
    step = sharded.make_sharded_map_step(cfg, mesh)
    refs = {"map_step": tuple(map(np.asarray, step(
        sgp, aux, *sharded.shard_orbits(mesh, q0, p0))))}
    refs["apply_map"] = tuple(map(np.asarray, sharded.apply_map_sharded(
        mesh, sgp, aux, q0, p0, td.NM_MAP, cfg)))
    q0, p0 = map(jnp.asarray, td.orbit_ics(td.B_ROLL, 2))
    traj = fast_apply.apply_map_fast(sgp, aux, q0, p0, td.NM_ROLL,
                                     MapConfig(newton_maxiter=5),
                                     fixed_iters=True)
    refs["rollout_float64"] = (np.asarray(traj.q), np.asarray(traj.p))
    pm = ps.pack_models(sgp, aux, mod_q=2 * np.pi)
    refs["rollout_float32"] = tuple(map(np.asarray,
                                        sharded.rollout_in_kernel_sharded(
        mesh, pm, q0.astype(jnp.float32), p0.astype(jnp.float32),
        td.NM_ROLL, interpret=True)))
    X, z = map(jnp.asarray, td.small_data())

    def objective(theta):
        hyp = 10.0 ** theta
        return nll(PER_SE, hyp[:2], hyp[2], jnp.asarray(1e-8), X, z)

    refs["restarts"] = sharded.fit_restarts_sharded(
        objective, td.X0S, mesh, steps=td.RESTART_STEPS)
    return refs


def _dp_ranks(world: int) -> list[int]:
    """Each rank's index on make_mesh's dp axis (rows of the mesh)."""
    return [r // (world // DP) for r in range(world)]


def _cols(a: np.ndarray, d: int) -> np.ndarray:
    s = a.shape[-1] // DP
    return a[..., d * s:(d + 1) * s]


def test_mesh_shape_matches_jax():
    """make_mesh's factoring of a world, as the JAX package's."""
    from sympgpr_tpu.distributed import sharded as jsh

    from sympgpr_tpu_torch.distributed.sharded import mesh_shape

    for n in (1, 2, 4, 6, 8):
        assert mesh_shape(n) == tuple(jsh.make_mesh(
            jax.devices()[:n]).devices.shape)
    assert mesh_shape(8) == (4, 2)


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh(worlds, world):
    """make_mesh's (dp, kp) mesh, and hybrid_mesh's (hosts, ranks of a
    host): one host outside the launcher."""
    for r in worlds[world].results():
        assert r["mesh"] == ((DP, world // DP), ("dp", "kp"))
        assert r["hybrid"] == ((1, world), ("chains", "kp"))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["map_step", "apply_map"])
def test_orbit_shards_match_jax(worlds, jax_refs, world, case):
    """The generic map step and the apply_map rollout on each rank's dp
    shard against JAX's sharded functions at 1e-12."""
    for r, d in zip(worlds[world].results(), _dp_ranks(world)):
        for got, ref in zip(r[case], jax_refs[case]):
            np.testing.assert_allclose(npy(got), _cols(ref, d), rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_rollout_sharded_float64(worlds, jax_refs, world):
    """Float64 columns: each rank's shard of the rollout (the plain version
    on CPU ranks) against the one-process port and against JAX's fast
    path on the unpacked models (sig folded into alpha moves the last
    digit), at 1e-12."""
    from sympgpr_tpu_torch.ops import cuda_step as cs

    pm = cs.pack_models(*_port_models(), mod_q=2 * math.pi,
                        dtype=torch.float64)
    q0, p0 = map(td.t64, td.orbit_ics(td.B_ROLL, 2))
    one = cs.rollout_in_kernel(pm, q0, p0, td.NM_ROLL)
    for r, dp in zip(worlds[world].results(), _dp_ranks(world)):
        got = r["rollout_torch.float64"]
        for g, o, j in zip(got, one, jax_refs["rollout_float64"]):
            assert g.shape == (td.NM_ROLL, td.B_ROLL // DP)
            np.testing.assert_allclose(npy(g), _cols(npy(o), dp),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(npy(g), _cols(j, dp), rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_rollout_sharded_float32_matches_jax_interpret(worlds, jax_refs,
                                                       world):
    """Float32 columns: each rank's shard against JAX's sharded Pallas
    kernel in interpret mode.  Two float32 implementations sum in other
    orders, so they are held at the float32 parity tolerance of
    tests/test_torch_cuda_step.py (5e-4 over the steps); the shard is
    also equal to the one-process port's columns."""
    from sympgpr_tpu_torch.ops import cuda_step as cs

    pm = cs.pack_models(*_port_models(), mod_q=2 * math.pi)
    q0, p0 = (torch.as_tensor(x, dtype=torch.float32)
              for x in td.orbit_ics(td.B_ROLL, 2))
    one = cs.rollout_in_kernel(pm, q0, p0, td.NM_ROLL)
    for r, dp in zip(worlds[world].results(), _dp_ranks(world)):
        got = r["rollout_torch.float32"]
        for g, o, j in zip(got, one, jax_refs["rollout_float32"]):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(npy(g), _cols(npy(o), dp))
            np.testing.assert_allclose(npy(g), _cols(j, dp), atol=5e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_rollout_sharded_refuses_a_batch_that_does_not_divide(worlds, world):
    for r in worlds[world].results():
        assert "multiple" in r["odd_batch"]


@pytest.mark.parametrize("world", WORLDS)
def test_fit_restarts_sharded_matches_jax(worlds, jax_refs, world):
    """Eight Adam restarts of 50 steps over the ranks (the objective of
    tests/test_distributed.py): the best theta and value against JAX's at
    1e-8, the same on every rank."""
    theta_j, val_j = jax_refs["restarts"]
    for r in worlds[world].results():
        theta, val = r["restarts"]
        np.testing.assert_allclose(theta, theta_j, rtol=1e-8)
        np.testing.assert_allclose(val, val_j, rtol=1e-8)


def _per_shard(kind: str, world: int):
    """The sampler run shard by shard in this process, seed * D + r."""
    from sympgpr_tpu_torch.gp.hmc import sample_hmc
    from sympgpr_tpu_torch.gp.nuts import sample_nuts

    sample = sample_hmc if kind == "hmc" else sample_nuts
    kw = td.sampler_kw(kind)
    seed = kw.pop("seed")
    x0s = td.sampler_x0s()
    s = td.CHAINS // world
    runs = [sample(td.port_logprob(), x0s[r * s:(r + 1) * s], td.SAMPLES,
                   seed=seed * world + r, **kw) for r in range(world)]
    return [torch.cat(f) for f in zip(*runs)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["hmc", "nuts"])
def test_sharded_sampler_is_the_per_shard_runs(worlds, world, kind):
    """Every rank returns the whole result in chain order, exactly the
    per-shard runs with seeds seed * D + r; chains of different shards
    from the same start draw different streams."""
    ref = _per_shard(kind, world)
    s = td.CHAINS // world
    for r in worlds[world].results():
        res = r[kind]
        assert len(res) == len(ref)
        for got, want in zip(res, ref):
            assert got.dtype == want.dtype
            assert torch.equal(got, want)
        assert not torch.equal(res.samples[0], res.samples[s])
