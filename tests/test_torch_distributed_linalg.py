"""The port's block-cyclic Cholesky, slab build, NLL and alpha
(``sympgpr_tpu_torch/linalg/cholesky.py``, ``distributed/large.py``) on
gloo worlds of 2 and 4 CPU ranks, against the JAX functions on the
conftest's CPU mesh cut to the same D.

Configurations (``torch_dist.CONFIGS``): a 1-D mesh of 2 ranks, a 1-D
mesh of 4 and make_mesh's 2 x 2 mesh, whose kp axis has D = 2.  The
block-cyclic layout is the same in both packages, so the results agree to
float64 rounding.  Both worlds start before the JAX references are
computed and run while they are.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_dist as td  # noqa: E402
from torch_parity import npy  # noqa: E402

CONFIGS = list(td.CONFIGS)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_linalg")
    return {w: td.launch(w, "linalg_cases", out) for w in (2, 4)}


@pytest.fixture(scope="module")
def jax_refs(worlds):
    from sympgpr_tpu.distributed import large
    from sympgpr_tpu.kernels import PER_SE, SUM_PER_SE
    from sympgpr_tpu.linalg.cholesky import distributed_cholesky

    P2, SIG, S2N = (jnp.asarray(v) for v in (td.P2, td.SIG, td.S2N))
    refs = {}
    for D in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:D]), ("kp",))
        r = {"chol256": distributed_cholesky(jnp.asarray(td.spd(256, 2)),
                                             mesh, block=32),
             "chol200": distributed_cholesky(jnp.asarray(td.spd(200, 5)),
                                             mesh, block=16)}
        X, z = map(jnp.asarray, td.data(40, 0))
        r["nll"] = large.sharded_nll_large(PER_SE, mesh, P2, SIG, S2N, X, z,
                                           block=8)
        X, z = map(jnp.asarray, td.data(24, 1))
        r["nll_sum"] = large.sharded_nll_large(SUM_PER_SE, mesh, P2, SIG,
                                               S2N, X, z, block=8)
        X, z = map(jnp.asarray, td.data(36, 2))
        r["alpha"] = large.sharded_alpha_large(PER_SE, mesh, P2, SIG, S2N, X,
                                               z, block=8)
        r["slab"] = large.build_K_cyclic(
            PER_SE, mesh, P2, SIG, S2N, jnp.asarray(td.data(32, 3)[0]),
            block=8)
        refs[D] = {k: np.asarray(v) for k, v in r.items()}
    return refs


def _ranks(worlds, config):
    """(each rank's results of ``config``, D of its kp axis, kp rank of
    each rank)."""
    world, D = td.CONFIGS[config]
    res = [r[config] for r in worlds[world].results()]
    return res, D, [r % D for r in range(world)]


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("case", ["chol256", "chol200"])
def test_distributed_cholesky_matches_jax(worlds, jax_refs, config, case):
    """Every rank returns the whole factor: JAX's and torch's own at 1e-9
    (n=200 pads to the block grid)."""
    res, D, _ = _ranks(worlds, config)
    n = 256 if case == "chol256" else 200
    K = td.t64(td.spd(n, 2 if n == 256 else 5))
    ref = npy(torch.linalg.cholesky(K))
    for r in res:
        assert r[case].shape == (n, n)
        np.testing.assert_allclose(npy(r[case]), jax_refs[D][case],
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(npy(r[case]), ref, rtol=1e-9, atol=1e-9)


# relative tolerance of the NLL: PER_SE's closed-form rows agree to
# rounding; SUM_PER_SE's autodiff Hessian blocks differ from JAX's by one
# ulp (2.2e-16 of max |K| 1.18), which Ky's condition number 1.9e7 turns
# into 1.7e-10 of the NLL, where the two packages' dense NLLs also lie
# 9.7e-11 apart; it is held at the JAX test's own 1e-9
NLL_RTOL = {"nll": 1e-10, "nll_sum": 1e-9}


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("case", ["nll", "nll_sum"])
def test_sharded_nll_large_matches_jax(worlds, jax_refs, config, case):
    """PER_SE and SUM_PER_SE (autodiff blocks), replicated, at
    ``NLL_RTOL``."""
    res, D, _ = _ranks(worlds, config)
    for r in res:
        np.testing.assert_allclose(float(r[case]), float(jax_refs[D][case]),
                                   rtol=NLL_RTOL[case])


@pytest.mark.parametrize("config", CONFIGS)
def test_sharded_alpha_large_matches_jax(worlds, jax_refs, config):
    """alpha in the reference layout, replicated, within 1e-8 of max
    |alpha| (Ky's condition number sets the floor, as in
    tests/test_large.py)."""
    res, D, _ = _ranks(worlds, config)
    ref = jax_refs[D]["alpha"]
    for r in res:
        np.testing.assert_allclose(npy(r["alpha"]), ref,
                                   atol=1e-8 * np.abs(ref).max())


@pytest.mark.parametrize("config", CONFIGS)
def test_slab_is_the_ranks_shard(worlds, jax_refs, config):
    """Each rank holds n_pad^2 / D entries: its shard of JAX's slab, at
    1e-12."""
    res, D, kp = _ranks(worlds, config)
    ref = jax_refs[D]["slab"]  # (D, nb_loc, block, n_pad)
    n_pad = ref.shape[-1]
    for r, d in zip(res, kp):
        assert r["slab"].shape == (1, *ref.shape[1:])
        assert r["slab"].numel() == n_pad * n_pad // D
        np.testing.assert_allclose(npy(r["slab"]), ref[d:d + 1], rtol=1e-12,
                                   atol=1e-12)


def test_interleave_and_pad_spd_match_jax():
    """The layout helpers in one process, exact."""
    from sympgpr_tpu.distributed import large as jlarge
    from sympgpr_tpu.linalg.cholesky import pad_spd as jpad

    from sympgpr_tpu_torch.distributed import large
    from sympgpr_tpu_torch.linalg.cholesky import pad_spd

    z = np.arange(10.0)
    zi = large.interleave_z(td.t64(z))
    np.testing.assert_array_equal(npy(zi),
                                  np.asarray(jlarge.interleave_z(z)))
    np.testing.assert_array_equal(npy(large.deinterleave_z(zi)), z)
    K = td.spd(20, 1)
    np.testing.assert_array_equal(npy(pad_spd(td.t64(K), 16)),
                                  np.asarray(jpad(jnp.asarray(K), 16)))
    assert pad_spd(td.t64(K), 10).shape == (20, 20)
