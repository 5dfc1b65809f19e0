"""The port's distributed value and gradient, robust factorization and
``fit_large`` (``sympgpr_tpu_torch/distributed/large.py``) and the
workload's ``run_distributed`` on gloo worlds of 2 and 4 CPU ranks,
against the JAX functions on the conftest's CPU mesh cut to the same D
(``torch_dist.CONFIGS``)."""

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
    out = tmp_path_factory.mktemp("dist_grad")
    return {w: td.launch(w, "grad_cases", out) for w in (2, 4)}


@pytest.fixture(scope="module")
def jax_refs(worlds):
    from sympgpr_tpu.distributed import large
    from sympgpr_tpu.kernels import PER_SE

    refs = {}
    for D in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:D]), ("kp",))
        X, z = map(jnp.asarray, td.data(40, 4))
        v, g = large.sharded_nll_large_value_and_grad(
            PER_SE, mesh, jnp.asarray(td.THETA), jnp.asarray(td.S2N), X, z,
            block=8)
        X, z = map(jnp.asarray, td.data(48, 6))
        model, hist = large.fit_large(PER_SE, mesh, X, z, 1e-6,
                                      jnp.asarray([0.0, 0.0, 0.3]), steps=8,
                                      lr=3e-2, block=8)
        refs[D] = dict(v=float(v), g=np.asarray(g),
                       params=np.asarray(model.params),
                       sig=float(model.sig), alpha=np.asarray(model.alpha),
                       hist=np.asarray(hist))
    return refs


def _ranks(worlds, config):
    world, D = td.CONFIGS[config]
    return [r[config] for r in worlds[world].results()], D


def _dense_alpha(params, sig, sig2n, X, z):
    from sympgpr_tpu_torch.gp.covariance import build_K_fast
    from sympgpr_tpu_torch.kernels import PER_SE

    K = build_K_fast(PER_SE, X, X, params, sig)
    return torch.linalg.solve(K + sig2n * torch.eye(K.shape[0],
                                                    dtype=K.dtype), z)


@pytest.mark.parametrize("config", CONFIGS)
def test_value_and_grad_matches_jax(worlds, jax_refs, config):
    """The forward-mode tangents carried by hand against JAX's jvp: value
    1e-9, gradient 1e-7 (relative), the same on every rank."""
    res, D = _ranks(worlds, config)
    for r in res:
        v, g = r["vg"]
        np.testing.assert_allclose(float(v), jax_refs[D]["v"], rtol=1e-9)
        np.testing.assert_allclose(npy(g), jax_refs[D]["g"], rtol=1e-7)


@pytest.mark.parametrize("config", CONFIGS)
def test_value_and_grad_factorizes_once(worlds, config):
    """One ``_factorize_cyclic`` a value and gradient, as a plain NLL: the
    tangents ride the primal factorization."""
    res, _ = _ranks(worlds, config)
    for r in res:
        assert r["vg_factorizations"] == 1
        assert r["nll_factorizations"] == 1


@pytest.mark.parametrize("config", CONFIGS)
def test_indefinite_ky_escalates_to_a_finite_nll(worlds, config):
    """Duplicated training points at a 1e-18 jitter: the factorization
    fails, the jitter escalation re-factors, and the NLL and its gradient
    stay finite (tests/test_large.py::test_robust_nll_survives_indefinite)."""
    res, _ = _ranks(worlds, config)
    for r in res:
        assert r["indefinite_factorizations"] > 1
        assert np.isfinite(float(r["indefinite_nll"]))
        v, g = r["indefinite_vg"]
        assert np.isfinite(float(v)) and np.all(np.isfinite(npy(g)))


@pytest.mark.parametrize("config", CONFIGS)
def test_fit_large_matches_jax(worlds, jax_refs, config):
    """8 Adam steps: the hyperparameters and the NLL history against JAX's
    fit_large at 1e-7; alpha against a dense solve at the fitted
    hyperparameters within 1e-8 of max |alpha|."""
    res, D = _ranks(worlds, config)
    ref = jax_refs[D]
    X, z = map(td.t64, td.data(48, 6))
    for r in res:
        f = r["fit"]
        np.testing.assert_allclose(npy(f["params"]), ref["params"],
                                   rtol=1e-7)
        np.testing.assert_allclose(float(f["sig"]), ref["sig"], rtol=1e-7)
        np.testing.assert_allclose(f["hist"], ref["hist"], rtol=1e-7)
        assert f["hist"][-1] < f["hist"][0]
        a = _dense_alpha(f["params"], f["sig"], f["sig2n"], X, z)
        np.testing.assert_allclose(npy(f["alpha"]), npy(a),
                                   atol=1e-8 * float(a.abs().max()))


@pytest.mark.parametrize("config", CONFIGS)
def test_fit_large_deployment_jitter(worlds, config):
    """deployment_jitter re-solves alpha at 1e-3 of max diag K, from the
    closed form (tests/test_large.py::test_fit_large_deployment_jitter)."""
    from sympgpr_tpu_torch.gp.covariance import build_K_fast
    from sympgpr_tpu_torch.kernels import PER_SE

    res, _ = _ranks(worlds, config)
    X, z = map(td.t64, td.data(32, 8))
    for r in res:
        f = r["jitter"]
        K = build_K_fast(PER_SE, X, X, f["params"], f["sig"])
        np.testing.assert_allclose(float(f["sig2n"]),
                                   1e-3 * float(K.diagonal().max()),
                                   rtol=1e-9)
        a = _dense_alpha(f["params"], f["sig"], f["sig2n"], X, z)
        np.testing.assert_allclose(npy(f["alpha"]), npy(a),
                                   atol=1e-9 * float(a.abs().max()))


@pytest.mark.parametrize("world", [2, 4])
def test_run_distributed_over_ranks(worlds, world):
    """``workloads/large_n.py::run_distributed`` on the ranks' group: every
    rank returns the same summary (the checkpoint is rank 0's), and the
    fit equals the one-rank run at 1e-9."""
    from sympgpr_tpu_torch.workloads import large_n

    outs = [r["run_distributed"] for r in worlds[world].results()]
    timing = ("t_train_s", "t_train_warm_s")
    for o in outs:
        assert {k: v for k, v in o.items() if k not in timing} == \
            {k: v for k, v in outs[0].items() if k not in timing}
    o = outs[0]
    assert o["devices"] == world and o["mesh"] == "gloo"
    assert o["dtype"] == "float64" and o["nll_decreased"]
    assert o["alpha_vs_dense_rel"] < 1e-8
    one = large_n.run_distributed(N=24, steps=3, block=8, device="cpu")
    np.testing.assert_allclose(o["hyp"], one["hyp"], rtol=1e-9)
    np.testing.assert_allclose(o["nll_last"], one["nll_last"], rtol=1e-9)
