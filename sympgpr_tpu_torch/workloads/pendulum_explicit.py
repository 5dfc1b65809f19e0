"""Pendulum with the separable sum kernel (PyTorch port of
``sympgpr_tpu/workloads/pendulum_explicit.py``).

Nm = 70, sig2_n = 1e-10: (lq, lp) trained jointly on the full
derivative-observation NLL of sum_per_se (``fit_sympgp``), then the
explicit map, Algorithm 2.  Backends as in ``pendulum_implicit``: the
float64 fast path or the float32 fused rollout.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from sympgpr_tpu_torch.gp.train import fit_sympgp
from sympgpr_tpu_torch.kernels import SUM_PER_SE
from sympgpr_tpu_torch.maps.symplectic import MapConfig
from sympgpr_tpu_torch.systems import pendulum as pend
from sympgpr_tpu_torch.workloads.pendulum_implicit import (
    energy_eosc,
    initial_conditions,
    rollout,
)
from sympgpr_tpu_torch.workloads.tokamak import _sync


def config() -> pend.PendulumConfig:
    return pend.PendulumConfig(Nm=70, sig2_n=1e-10)


def run(cfg: pend.PendulumConfig | None = None, backend: str = "generic",
        *, device: torch.device | str) -> dict[str, Any]:
    cfg = cfg or config()
    device = torch.device(device)
    data = pend.training_data(cfg, device)

    t0 = time.time()
    sgp, _ = fit_sympgp(
        SUM_PER_SE, data["X"], data["z"], sig2n=cfg.sig2_n, x0=(-1.0, -1.0),
        fixed_sig=2.0 * float(data["z"].abs().max()) ** 2)
    _sync(device)
    t_train = time.time() - t0

    q0, p0 = initial_conditions(cfg, device)
    t0 = time.time()
    # the sum kernel runs Algorithm 2 (the explicit map) in both backends
    traj = rollout(sgp, None, q0, p0, cfg.nm, backend,
                   MapConfig(explicit=True))
    _sync(device)
    t_apply = time.time() - t0
    return dict(
        cfg=dataclasses.asdict(cfg),
        backend=backend,
        device=str(device),
        hyp=sgp.params.cpu().numpy(),
        training_error=float(sgp.training_error()),
        t_train=t_train,
        t_apply=t_apply,
        Eosc=energy_eosc(cfg, traj),
        traj=traj,
        models=(sgp, None),
    )


def main(device: str = "cuda"):
    out = run(device=device)
    print(f"lq={out['hyp'][0]:.2f} lp={out['hyp'][1]:.2f}")
    print(f"training error {out['training_error']:.1e}")
    print(f"Energy oscillation: {np.nanmean(out['Eosc']):.1e}")


if __name__ == "__main__":
    main()
