"""Shared helpers of the PyTorch-port tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU with x64 on (``tests/conftest.py``), the port on the CPU
device.  Importing this module needs torch and numpy only, so the GPU-only
test file can use it on a machine without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# the suite runs under pytest-xdist with several workers: one intra-op
# thread each keeps them from oversubscribing the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


def t64(x) -> torch.Tensor:
    """numpy-convertible -> float64 CPU tensor."""
    return torch.as_tensor(np.array(x, np.float64))


def tt(x, dtype=torch.float64, device=CPU) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def npy(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_models_to_port(sgp, aux, device=CPU):
    """JAX fitted models -> the port's, through the shared artifact keys."""
    from sympgpr_tpu.gp import model as jm

    from sympgpr_tpu_torch.gp.model import models_from_arrays

    d = jm._to_dict(sgp, "sympgp.")
    if aux is not None:
        d.update(jm._to_dict(aux, "aux."))
    s, a, _ = models_from_arrays(d, device)
    return s, a


def toy_data(n=20, seed=0):
    """Smooth mixed-variable training set (q, P, p, targets) in float64."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 2 * np.pi, n)
    P = rng.uniform(-1, 1, n)
    p = rng.uniform(-1, 1, n)
    X = np.stack([q, P], 1)
    z = np.concatenate([0.1 * np.sin(q) * P, 0.1 * np.cos(q) + 0.05 * P])
    Xp = np.stack([q, p], 1)
    zp = 0.1 * np.sin(q) * p
    return X, z, Xp, zp


def boundary_data(n: int, seed: int, shift: float):
    """(X, z) float64 training set of a map near the tokamak's loss boundary:
    P in [10, 14] (r = 0.5 at cos q = 0.12 for P = 12), q turned by
    ~``shift`` a step while P moves little."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 2 * np.pi, n)
    P = rng.uniform(10, 14, n)
    X = np.stack([q, P], 1)
    z = np.concatenate([0.01 * np.sin(q), shift + 0.1 * np.cos(q)])
    return X, z


def ics(seed=1, b=128):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 2 * np.pi, b), rng.uniform(-0.5, 0.5, b)


def pendulum_posterior_data(n: int = 18):
    """(X, z) numpy training set of the reduced pendulum workload whose
    hyperposterior the sampler tests draw (``tests/test_posterior_parity.py``),
    from the JAX package's system."""
    from sympgpr_tpu.systems import pendulum as sys_pend

    data = sys_pend.training_data(sys_pend.PendulumConfig(N=n))
    return np.asarray(data["X"]), np.asarray(data["z"])
