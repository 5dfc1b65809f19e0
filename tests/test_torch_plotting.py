"""``plotting.py`` and ``profiling.py`` of the port: the portrait and
energy-drift figures, ``cost_landscape``'s grid and gradients against the
JAX package's on the same objective, and the timer and launch counters on
the CPU (the spans: ``tests/test_torch_tracing.py``)."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("matplotlib")

import jax.numpy as jnp  # noqa: E402
import matplotlib.axes  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, toy_data  # noqa: E402

from sympgpr_tpu_torch import plotting, profiling  # noqa: E402

PNG = b"\x89PNG\r\n\x1a\n"
RTOL = 1e-10  # cost_landscape's grid and autograd gradient, port vs JAX
BOUNDS = ((-0.4, 0.3), (-0.2, 0.5))


def test_portrait_and_energy_drift_write_pngs(tmp_path):
    q = torch.linspace(0, 6, 50, dtype=torch.float64)
    p = torch.sin(q)
    one = plotting.portrait(q, p, path=tmp_path / "one.png", title="t")
    three = plotting.portrait(q.numpy(), p.numpy(), q, p + 0.1,
                              path=tmp_path / "three.png")
    drift = plotting.energy_drift(1.0 + 1e-9 * q, path=tmp_path / "e.png")
    for path in (one, three, drift):
        assert open(path, "rb").read(8) == PNG


def _capture_contourf(monkeypatch) -> list:
    """Record the Z grid of every contourf call."""
    grids = []
    orig = matplotlib.axes.Axes.contourf

    def contourf(self, X, Y, Z, *a, **kw):
        grids.append(np.array(Z))
        return orig(self, X, Y, Z, *a, **kw)

    monkeypatch.setattr(matplotlib.axes.Axes, "contourf", contourf)
    return grids


def test_cost_landscape_is_jax(tmp_path, monkeypatch):
    """A GP NLL over log10 lengthscales (sig fixed): the port's batched
    objective through ``nll_batched``, JAX's scalar one through ``nll``;
    the grid and the autograd gradient at 1e-10, the finite differences
    beside them."""
    from sympgpr_tpu import plotting as jplotting
    from sympgpr_tpu.gp import likelihood as jlik
    from sympgpr_tpu.kernels import PER_SE as JPER_SE

    from sympgpr_tpu_torch.gp.likelihood import nll_batched
    from sympgpr_tpu_torch.kernels import PER_SE

    X, z, _, _ = toy_data(10, seed=4)
    sig, s2n = 1.3, 1e-6
    Xt, zt = torch.as_tensor(X), torch.as_tensor(z)

    def objective(pts):
        return nll_batched(PER_SE, 10.0 ** pts,
                           torch.full((pts.shape[0],), sig,
                                      dtype=torch.float64), s2n, Xt, zt)

    def jobjective(th):
        return jlik.nll(JPER_SE, 10.0 ** th, jnp.asarray(sig),
                        jnp.asarray(s2n), jnp.asarray(X), jnp.asarray(z))

    grids = _capture_contourf(monkeypatch)
    path, g_ad, g_fd = plotting.cost_landscape(
        objective, BOUNDS, path=tmp_path / "c.png", n=6, device=CPU)
    jpath, jg_ad, jg_fd = jplotting.cost_landscape(
        jobjective, BOUNDS, path=str(tmp_path / "cj.png"), n=6)
    assert open(path, "rb").read(8) == PNG
    assert len(grids) == 2 and grids[0].shape == (6, 6)
    np.testing.assert_allclose(grids[0], grids[1], rtol=RTOL)
    np.testing.assert_allclose(g_ad, np.asarray(jg_ad), rtol=RTOL)
    np.testing.assert_allclose(g_fd, jg_fd, rtol=1e-6)
    np.testing.assert_allclose(g_ad, g_fd, rtol=1e-5)


def test_best_ms_on_the_host_clock():
    calls = []
    ms = profiling.best_ms(lambda: calls.append(1), reps=4, calls=3,
                           device=CPU)
    assert len(calls) == 1 + 4 * 3 and 0 < ms < 1e3
    calls.clear()
    profiling.best_ms(lambda: calls.append(1), reps=2, warmup=False,
                      device=None)
    assert len(calls) == 2


def test_launch_counts_read_and_zero():
    from sympgpr_tpu_torch.ops import cuda_cov, cuda_step

    cuda_step.LAUNCHES += 2
    assert profiling.launch_counts()["rollout"] >= 2
    counts = profiling.launch_counts(zero=True)
    assert counts == {"cov_fwd": 0, "cov_bwd": 0, "syrk": 0, "trimm": 0,
                      "matvec": 0, "rollout": 0, "rollout_cluster": 0,
                      "rollout_split": 0}
    assert cuda_cov.LAUNCHES_FWD == 0


def test_launch_counts_zero_the_matvec_counter():
    from sympgpr_tpu_torch.ops import cuda_matvec

    cuda_matvec.LAUNCHES += 3
    assert profiling.launch_counts()["matvec"] >= 3
    profiling.launch_counts(zero=True)
    assert cuda_matvec.LAUNCHES == 0


def test_launch_counts_zero_the_split_counter():
    from sympgpr_tpu_torch.ops import cuda_step

    cuda_step.LAUNCHES_SPLIT += 3
    assert profiling.launch_counts()["rollout_split"] >= 3
    profiling.launch_counts(zero=True)
    assert cuda_step.LAUNCHES_SPLIT == 0
    assert profiling.launch_counts()["rollout_split"] == 0
