"""The port's CLI surface against the JAX CLI: ``_summarize``'s keys,
``pack_points`` / ``unpack_flat``, ``bench --large-n`` and
``--rollout-sweep``, ``--backend`` with the JAX names, ``run large_n`` and
``--plots``, on the CPU."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import functools  # noqa: E402
import json  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import npy  # noqa: E402

from sympgpr_tpu_torch import __main__ as cli  # noqa: E402
from sympgpr_tpu_torch.workloads import large_n  # noqa: E402

# the JAX CPU key set of large_n.measure (sympgpr_tpu/workloads/large_n.py)
MEASURE_CPU_KEYS = {
    "N", "n", "dtype", "device", "build_s", "build_entries_per_s",
    "cholesky_s", "cholesky_gflops", "build_plus_chol_gflops", "nll_eval_s",
    "train_step_s", "train_step_autodiff_s", "train_step_over_eval",
    "adam_compile_s", "adam_10step_s", "nll_first", "nll_last",
    "nll_decreased"}


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_summarize_keys_match_jax():
    """One result holding every summarised key gives both packages'
    ``_summarize`` the same keys (``n_train`` among them)."""
    from sympgpr_tpu import __main__ as jcli

    out = {k: 1.5 for k in ("training_error", "t_train", "t_apply",
                            "one_step_mse", "period_ratio", "n_lost",
                            "n_train")}
    out.update(method="implicit", optimizer="lbfgs",
               Eosc=np.array([1e-3, np.nan]), gd=np.array([2e-4]),
               Eosc_se=np.array([3e-3]), hyp=np.array([0.5, 1.0]),
               unrelated=7)
    want = jcli._summarize(out)
    got = cli._summarize(out)
    assert set(got) == set(want)
    assert "n_train" in got
    assert json.dumps(got, default=str) == json.dumps(want, default=str)


def test_pack_points_unpack_flat_match_jax():
    from sympgpr_tpu.gp.covariance import pack_points as jpack
    from sympgpr_tpu.gp.covariance import unpack_flat as junpack

    from sympgpr_tpu_torch.gp.covariance import pack_points, unpack_flat

    q = np.arange(4.0)
    P = np.arange(4.0) + 10
    X = pack_points(torch.as_tensor(q), torch.as_tensor(P))
    assert X.shape == (4, 2)
    np.testing.assert_array_equal(npy(X), np.asarray(jpack(jnp.asarray(q),
                                                           jnp.asarray(P))))
    flat = np.concatenate([q, P])
    np.testing.assert_array_equal(npy(unpack_flat(torch.as_tensor(flat))),
                                  np.asarray(junpack(jnp.asarray(flat))))
    np.testing.assert_array_equal(npy(unpack_flat(torch.as_tensor(flat))),
                                  npy(X))


def test_bench_large_n_prints_the_metric(capsys):
    cli.main(["bench", "--large-n", "--n", "32", "--reps", "2",
              "--device", "cpu"])
    out = _last_json(capsys)
    assert list(out) == ["metric", "value", "unit", "detail"]
    assert out["metric"] == "large_n_build_plus_cholesky_gflops"
    assert out["unit"] == "GFLOP/s"
    assert set(out["detail"]) == MEASURE_CPU_KEYS
    assert out["detail"]["N"] == 32 and out["detail"]["dtype"] == "float32"
    assert out["value"] == out["detail"]["build_plus_chol_gflops"] > 0


def test_bench_rollout_sweep_at_small_sizes(capsys, monkeypatch):
    """The sweep through its function at small sizes (the CLI's defaults
    are the card's), and the CLI's wiring around it."""
    small = functools.partial(large_n.rollout_sweep, Ns=(16, 40), B=8, nm=3)
    monkeypatch.setattr(large_n, "rollout_sweep", small)
    cli.main(["bench", "--rollout-sweep", "--device", "cpu"])
    out = _last_json(capsys)
    assert out["metric"] == "rollout_sweep"
    d = out["detail"]
    assert d["B"] == 8 and d["nm"] == 3
    for N in (16, 40):
        for k in ("ms", "steps_per_s", "pair_gsteps_per_s"):
            assert np.isfinite(d[f"N{N}_{k}"]) and d[f"N{N}_{k}"] > 0


@pytest.mark.parametrize("argv", [
    ["bench", "--steps", "5"], ["bench", "--rollout-sweep", "--distributed"],
    ["bench", "--large-n", "--steps", "5"],
    ["run", "tokamak", "--distributed"]])
def test_unported_commands_exit(argv, capsys):
    """``--distributed`` or ``--steps`` where they do not apply (the
    distributed fit is ``large_n`` alone; plain ``bench`` takes neither)
    exit non-zero with a message, before touching any device."""
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--device", "cpu"])
    msg = str(e.value.code)
    assert e.value.code not in (0, None)
    assert "--distributed" in msg


def test_every_jax_workload_name_is_accepted():
    """Every name of the JAX CLI resolves to a workload of the port."""
    from sympgpr_tpu import __main__ as jcli

    jcli._register()
    port = {**cli.WORKLOADS, **cli.OTHERS, "large_n": None}
    for name in jcli.WORKLOADS:
        assert cli.resolve(name) in port, name
    assert cli.resolve("tokamak_pallas") == "tokamak_kernel"
    assert cli.resolve("pendulum_pallas") == "pendulum_implicit_kernel"
    assert cli.resolve("henon_pallas") == "henon_heiles_kernel"
    with pytest.raises(SystemExit):
        cli.resolve("no_such_workload")


@pytest.mark.parametrize("name", ["tokamak", "tokamak_split",
                                  "pendulum_implicit", "standard_map",
                                  "standard_map_explicit", "henon_heiles",
                                  "pert_pendulum", "tokamak_pallas"])
def test_backend_pallas_is_kernel(name):
    """``--backend pallas`` is ``--backend kernel``: the ``_kernel``
    workload, whatever the name's own backend; ``generic`` its float64
    twin.  Names without both backends keep theirs."""
    base = cli.resolve(name).removesuffix("_kernel")
    for n in (name, cli.resolve(name)):
        assert cli.resolve(n, "pallas") == cli.resolve(n, "kernel") \
            == f"{base}_kernel"
        assert cli.resolve(n, "generic") == base
    for n in ("tokamak_large", "standard_map_large", "large_n"):
        assert cli.resolve(n, "pallas") == n


def test_backend_pallas_runs_the_kernel_workload(capsys):
    """The same run through ``standard_map --backend pallas`` and
    ``standard_map_kernel``: equal summaries but for the wall times."""
    outs = []
    for argv in (["standard_map", "--backend", "pallas"],
                 ["standard_map_kernel"]):
        cli.main(["run", *argv, "--nm", "3", "--device", "cpu"])
        out = _last_json(capsys)
        for k in ("t_train", "t_apply"):
            out.pop(k)
        outs.append(out)
    assert outs[0] == outs[1]


def test_run_large_n_prints_measure(capsys):
    cli.main(["run", "large_n", "--n", "16", "--device", "cpu"])
    out = _last_json(capsys)
    assert set(out) == MEASURE_CPU_KEYS and out["N"] == 16


def test_plots_write_the_portrait(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    cli.main(["run", "standard_map", "--nm", "3", "--plots",
              str(tmp_path), "--device", "cpu"])
    png = tmp_path / "standard_map_portrait.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert f"wrote {png}" in capsys.readouterr().out


def test_plots_without_matplotlib_fail_before_the_run(tmp_path,
                                                      monkeypatch):
    """Where matplotlib is missing, ``--plots`` raises before the
    workload runs (``tokamak_large``: before its fit and the reference)."""
    import sys

    from sympgpr_tpu_torch.workloads import tokamak_large

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(cli, "_run_other", lambda *a: pytest.fail("ran"))
    monkeypatch.setattr(tokamak_large.tk, "training_data",
                        lambda *a: pytest.fail("ran"))
    with pytest.raises(ImportError):
        cli.main(["run", "standard_map", "--plots", str(tmp_path),
                  "--device", "cpu"])
    with pytest.raises(ImportError):
        tokamak_large.run(n_train=8, nm=4, steps=1, plots=str(tmp_path),
                          device="cpu")
