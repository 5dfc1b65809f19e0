"""PyTorch port vs JAX: fitted-model containers and the shared ``.npz``
artifact format.

Cholesky factors are held at 1e-12 relative and 1e-12 absolute: their
trailing entries are small differences of O(1) numbers and carry the
absolute rounding of those.  alpha = Ky^{-1} z is held
at 1e-9 relative: it inherits the conditioning of Ky (~1e6 at the jitter
used here), which amplifies ~1e-16 rounding differences.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, jax_models_to_port, npy, t64, toy_data  # noqa: E402,E501

from sympgpr_tpu.gp import model as jm  # noqa: E402
from sympgpr_tpu.kernels import variants as jvar  # noqa: E402
from sympgpr_tpu_torch.gp import model as tm  # noqa: E402
from sympgpr_tpu_torch.kernels import variants as tvar  # noqa: E402


def _pair(name="per_se", n=16, sig2n=1e-6):
    X, z, Xp, zp = toy_data(n, seed=3)
    params = [0.9, 1.2, 0.55][: jvar.get_kernel(name).n_params]
    js = jm.SympGP.create(jvar.get_kernel(name), jnp.asarray(params), 1.5,
                          sig2n, jnp.asarray(X), jnp.asarray(z))
    ts = tm.SympGP.create(tvar.get_kernel(name), params, 1.5, sig2n, t64(X),
                          z)
    ja = jm.AuxGP.create(jvar.get_kernel(name), jnp.asarray(params), 0.7,
                         sig2n, jnp.asarray(Xp), jnp.asarray(zp))
    ta = tm.AuxGP.create(tvar.get_kernel(name), params, 0.7, sig2n, t64(Xp),
                         zp)
    return js, ts, ja, ta


def _close(t, j):
    np.testing.assert_allclose(npy(t.L), np.asarray(j.L), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(npy(t.alpha), np.asarray(j.alpha), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(npy(t.sig2n), np.asarray(j.sig2n),
                               rtol=1e-12)


@pytest.mark.parametrize("name", ["per_se", "se_se", "per_se_freq"])
def test_create_matches_jax(name):
    js, ts, ja, ta = _pair(name)
    _close(ts, js)
    _close(ta, ja)
    assert ts.n_train == 16 and ts.params.dtype == torch.float64
    assert ta.delta is True


def test_for_deployment_matches_jax():
    js, ts, ja, ta = _pair()
    _close(ts.for_deployment(1e-3), js.for_deployment(1e-3))
    _close(ta.for_deployment(1e-3), ja.for_deployment(1e-3))
    # hyperparameters are untouched
    np.testing.assert_array_equal(npy(ts.for_deployment(1e-3).params),
                                  npy(ts.params))


def test_training_error_matches_jax():
    """MSE(z, K alpha) = mean((sig2n alpha)^2): the bias the jitter
    leaves; held at the relative tolerance of alpha."""
    js, ts, _, _ = _pair()
    np.testing.assert_allclose(float(ts.training_error()),
                               float(js.training_error()), rtol=1e-8)
    d = ts.for_deployment(1e-3)
    np.testing.assert_allclose(float(d.training_error()),
                               float(js.for_deployment(1e-3).training_error()),
                               rtol=1e-8)


def test_npz_round_trip_jax_port_jax(tmp_path):
    """JAX save -> port load -> port save -> JAX load keeps every array
    and its dtype bit for bit."""
    js, _, ja, _ = _pair("per_se_freq")
    p1, p2 = tmp_path / "jax.npz", tmp_path / "port.npz"
    jm.save_models(str(p1), js, ja, note=np.arange(3))
    ts, ta, extra = tm.load_models(str(p1), CPU)
    assert ts.kernel is tvar.PER_SE_FREQ and ta.delta is True
    np.testing.assert_array_equal(extra["note"], np.arange(3))
    tm.save_models(str(p2), ts, ta, **extra)
    js2, ja2, extra2 = jm.load_models(str(p2))
    np.testing.assert_array_equal(extra2["note"], np.arange(3))
    for a, b in ((js, js2), (ja, ja2)):
        assert a.kernel == b.kernel
        for f in tm._ARRAY_FIELDS:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    with np.load(p1) as f1, np.load(p2) as f2:
        assert sorted(f1.files) == sorted(f2.files)


def test_models_from_arrays_keeps_float32():
    X, z, Xp, zp = toy_data(10, seed=5)
    js = jm.SympGP.create(jvar.PER_SE, jnp.asarray([0.9, 1.2], jnp.float32),
                          1.5, 1e-2, jnp.asarray(X, jnp.float32),
                          jnp.asarray(z, jnp.float32))
    ts, ta = jax_models_to_port(js, None)
    assert ta is None
    assert ts.alpha.dtype == torch.float32 and ts.X.dtype == torch.float32
    np.testing.assert_array_equal(npy(ts.alpha), np.asarray(js.alpha))
    assert ts.device == CPU
