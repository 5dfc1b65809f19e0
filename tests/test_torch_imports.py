"""The port imports no JAX: every module of ``sympgpr_tpu_torch`` imports
with ``jax`` blocked, and the CLI lists its workloads that way."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BLOCK = ("import sys\n"
         "for m in ('jax', 'jaxlib', 'flax', 'optax', 'sympgpr_tpu'):\n"
         "    sys.modules[m] = None\n")


def _run(code: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", BLOCK + code, *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_every_module_imports_without_jax():
    code = (
        "import importlib, pkgutil\n"
        "import sympgpr_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                               pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'flax', 'optax', 'sympgpr_tpu', 'triton')\n"
        "          and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print(len(names))\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20  # every module was reached


def test_bench_imports_without_jax():
    """The port's headline benchmark imports without JAX, and not the
    repository's root ``bench.py`` (the JAX package's)."""
    code = (
        "from sympgpr_tpu_torch import bench\n"
        "from sympgpr_tpu_torch import __main__ as cli\n"
        "assert 'bench' not in sys.modules, sys.modules['bench']\n"
        "assert bench.__file__.endswith('sympgpr_tpu_torch/bench.py')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('jax', 'sympgpr_tpu') and sys.modules[m] is not None]\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr


def test_large_n_modules_import_without_jax():
    """The large-N path's modules by name (the walk above must reach
    them too): kernels' wrappers, the triangular inverse, the workload."""
    code = (
        "import importlib\n"
        "for n in ('ops.cuda_cov', 'ops.cuda_syrk', 'ops.cuda_trimm',\n"
        "          'ops.cuda_matvec', 'linalg.triangular', 'gp.likelihood',\n"
        "          'gp.train',\n"
        "          'workloads.tokamak_large'):\n"
        "    importlib.import_module('sympgpr_tpu_torch.' + n)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('jax', 'sympgpr_tpu') and sys.modules[m] is not None]\n"
        "from sympgpr_tpu_torch.gp import likelihood, train\n"
        "assert hasattr(likelihood, 'nll_value_and_grad')\n"
        "assert hasattr(train, 'fit_sympgp_ondevice')\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr


def test_standard_map_and_pendulum_modules_import_without_jax():
    """The standard map's and the pendulum's modules by name."""
    code = (
        "import importlib\n"
        "for n in ('systems.standard_map', 'systems.pendulum',\n"
        "          'workloads.standard_map', 'workloads.pendulum_implicit',\n"
        "          'workloads.pendulum_explicit',\n"
        "          'workloads.pendulum_period_unknown'):\n"
        "    importlib.import_module('sympgpr_tpu_torch.' + n)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('jax', 'sympgpr_tpu') and sys.modules[m] is not None]\n"
        "from sympgpr_tpu_torch.gp import likelihood, train\n"
        "from sympgpr_tpu_torch.eval import metrics\n"
        "assert hasattr(likelihood, 'nll_separable')\n"
        "assert hasattr(train, 'fit_sympgp_separable')\n"
        "assert hasattr(metrics, 'pendulum_energy')\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr


def test_pert_pendulum_henon_and_generic_map_modules_import_without_jax():
    """The perturbed pendulum's, Henon-Heiles' and the generic map path's
    modules by name."""
    code = (
        "import importlib\n"
        "for n in ('systems.pert_pendulum', 'systems.henon_heiles',\n"
        "          'workloads.pert_pendulum', 'workloads.henon_heiles',\n"
        "          'gp.predict', 'maps.symplectic'):\n"
        "    importlib.import_module('sympgpr_tpu_torch.' + n)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('jax', 'sympgpr_tpu') and sys.modules[m] is not None]\n"
        "from sympgpr_tpu_torch.eval import metrics\n"
        "from sympgpr_tpu_torch.gp import predict\n"
        "from sympgpr_tpu_torch.maps import symplectic\n"
        "from sympgpr_tpu_torch.systems import tokamak\n"
        "assert hasattr(metrics, 'henon_energy')\n"
        "assert hasattr(predict, 'predict_df')\n"
        "assert hasattr(symplectic, 'calc_P')\n"
        "assert hasattr(tokamak, 'integrate_fieldlines_rk4')\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr


def test_surface_modules_import_without_jax():
    """The large-N workload, profiling, plotting, guiding-center, native
    and CPU-baseline modules by name (the walk above must reach them
    too)."""
    code = (
        "import importlib\n"
        "for n in ('workloads.large_n', 'profiling', 'plotting',\n"
        "          'systems.guiding_center', 'native',\n"
        "          'baselines.reference_cpu'):\n"
        "    importlib.import_module('sympgpr_tpu_torch.' + n)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('jax', 'sympgpr_tpu') and sys.modules[m] is not None]\n"
        "from sympgpr_tpu_torch.workloads import large_n\n"
        "assert hasattr(large_n, 'measure')\n"
        "assert hasattr(large_n, 'rollout_sweep')\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr


def test_distributed_modules_import_without_jax():
    """The distributed slice's modules by name: the process group and
    meshes, the block-cyclic fit, the sharding, the distributed Cholesky."""
    code = (
        "import importlib\n"
        "for n in ('distributed', 'distributed.init', 'distributed.large',\n"
        "          'distributed.sharded', 'linalg.cholesky'):\n"
        "    importlib.import_module('sympgpr_tpu_torch.' + n)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('jax', 'sympgpr_tpu') and sys.modules[m] is not None]\n"
        "from sympgpr_tpu_torch.distributed import large, sharded\n"
        "from sympgpr_tpu_torch.workloads import large_n\n"
        "assert hasattr(large, 'sharded_nll_large_value_and_grad')\n"
        "assert hasattr(sharded, 'rollout_in_kernel_sharded')\n"
        "assert hasattr(large_n, 'run_distributed')\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr


# the port's top-level names beyond the JAX package's
PORT_ONLY = {"nll_batched", "models_from_arrays", "fit_batch_adam",
             "minimize_adam", "sample_nuts", "sample_nuts_sharded"}


def _public(pkg) -> set[str]:
    import types

    return {n for n, v in vars(pkg).items() if not n.startswith("_")
            and not isinstance(v, types.ModuleType)}


def test_exports_are_jax_names():
    """The port exports every name of ``sympgpr_tpu`` and its own
    extras."""
    import sympgpr_tpu
    import sympgpr_tpu_torch

    assert _public(sympgpr_tpu_torch) - PORT_ONLY == _public(sympgpr_tpu)


def test_cli_without_jax():
    r = _run("import runpy; sys.argv = ['sympgpr_tpu_torch', 'list'];"
             "runpy.run_module('sympgpr_tpu_torch', run_name='__main__')")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [
        "henon_heiles", "henon_heiles_kernel", "henon_pallas", "large_n",
        "pendulum_explicit", "pendulum_explicit_kernel", "pendulum_implicit",
        "pendulum_implicit_kernel", "pendulum_pallas",
        "pendulum_period_unknown", "pendulum_period_unknown_kernel",
        "pert_pendulum", "pert_pendulum_kernel", "standard_map",
        "standard_map_explicit", "standard_map_explicit_kernel",
        "standard_map_kernel", "standard_map_large", "tokamak",
        "tokamak_kernel", "tokamak_large", "tokamak_pallas", "tokamak_split",
        "tokamak_split_kernel"]


def test_cli_cuda_device_needs_a_gpu():
    """``--device cuda`` (the default) fails rather than run elsewhere."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run("import runpy\n"
             "sys.argv = ['sympgpr_tpu_torch', 'run', 'tokamak', '--nm', '2']\n"
             "runpy.run_module('sympgpr_tpu_torch', run_name='__main__')\n")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
