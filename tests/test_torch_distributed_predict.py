"""The port's distributed posterior prediction (``factorize_large``,
``predict_df_large``, ``DistFactor`` in
``sympgpr_tpu_torch/distributed/large.py``) on gloo worlds of 2 and 4 CPU
ranks, against the JAX functions on the conftest's CPU mesh cut to the
same D (``torch_dist.CONFIGS``), and the refusal of a factor made on
another geometry."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_dist as td  # noqa: E402
from torch_parity import npy  # noqa: E402

CONFIGS = list(td.CONFIGS)


def _jax_dense():
    from sympgpr_tpu.gp.model import SympGP
    from sympgpr_tpu.kernels import PER_SE

    X, z = map(jnp.asarray, td.data(40, 9))
    return SympGP.create(PER_SE, jnp.asarray(td.P2), td.SIG, td.S2N, X, z)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The ranks take JAX's dense alpha, so both packages' means read the
    same coefficients (Ky's condition number ~4e7 at the 1e-6 jitter)."""
    out = tmp_path_factory.mktemp("dist_predict")
    path = str(out / "alpha.npy")
    np.save(path, np.asarray(_jax_dense().alpha))
    return {w: td.launch(w, "predict_cases", out, path) for w in (2, 4)}


@pytest.fixture(scope="module")
def jax_refs(worlds):
    from sympgpr_tpu.distributed import large
    from sympgpr_tpu.gp.model import SympGP
    from sympgpr_tpu.gp.predict import predict_df

    dense = _jax_dense()
    model = SympGP.from_alpha(dense.kernel, dense.params, dense.sig,
                              dense.sig2n, dense.X, dense.z, dense.alpha)
    V, V2 = (jnp.asarray(td.data(m, s)[0]) for m, s in ((6, 10), (7, 13)))
    refs = {"dense2": tuple(map(np.asarray, predict_df(dense, V2)))}
    for D in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:D]), ("kp",))
        refs[D] = tuple(map(np.asarray,
                            large.predict_df_large(model, mesh, V, block=8)))
    return refs


def _ranks(worlds, config):
    world, D = td.CONFIGS[config]
    return [r[config] for r in worlds[world].results()], D


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("case", ["fresh", "reused"])
def test_predict_df_large_matches_jax(worlds, jax_refs, config, case):
    """Mean and variance, fresh and through a reused factor, against JAX's
    predict_df_large at 1e-9 (the mean's absolute floor: |alpha| ~ 1e3
    against entries of the posterior ~1, as tests/test_large.py)."""
    res, D = _ranks(worlds, config)
    mean_j, var_j = jax_refs[D]
    for r in res:
        mean, var = r[case]
        np.testing.assert_allclose(npy(mean), mean_j, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(npy(var), var_j, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("config", CONFIGS)
def test_factor_reuse_factorizes_once(worlds, jax_refs, config):
    """factorize_large runs the robust factorization once and two
    prediction batches through its factor run none; the second batch
    against JAX's dense predict_df (tests/test_large.py's tolerances)."""
    res, _ = _ranks(worlds, config)
    mean_d, var_d = jax_refs["dense2"]
    for r in res:
        assert r["factorizations_factor"] == 1
        assert r["factorizations_after"] == 1
        mean, var = r["reused2"]
        np.testing.assert_allclose(npy(mean), mean_d, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(npy(var), var_d, rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("config", CONFIGS)
def test_factor_of_another_geometry_is_refused(worlds, config):
    """A factor made for another N, axis or axis size D is refused."""
    res, _ = _ranks(worlds, config)
    for r in res:
        assert len(r["refused"]) == 3
        assert all("geometry" in m for m in r["refused"])


def test_factor_of_another_mesh_is_refused(worlds):
    """A factor of the 2 x 2 mesh's kp axis (D = 2) on a 1-D mesh of four
    ranks (D = 4)."""
    for r in worlds[4].results():
        assert r["cross_mesh_refused"] is not None
        assert "D=2" in r["cross_mesh_refused"]
