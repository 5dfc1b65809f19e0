"""Pendulum with the periodicity learned as a hyperparameter (PyTorch port
of ``sympgpr_tpu/workloads/pendulum_period_unknown.py``).

N = 50, Nm = 100: both GPs use the per_se_freq kernel with a learned
frequency; the recovered periodicity is reported as ``0.5 / freq`` (1.0
for the true 2 pi period).  Backends as in ``pendulum_implicit``; the
kernel backend takes 8 Newton iterations.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from sympgpr_tpu_torch.gp.train import fit_auxgp, fit_sympgp
from sympgpr_tpu_torch.kernels import PER_SE_FREQ
from sympgpr_tpu_torch.maps.symplectic import MapConfig
from sympgpr_tpu_torch.systems import pendulum as pend
from sympgpr_tpu_torch.workloads.pendulum_implicit import (
    energy_eosc,
    initial_conditions,
    rollout,
)
from sympgpr_tpu_torch.workloads.tokamak import _sync


def config() -> pend.PendulumConfig:
    return pend.PendulumConfig(N=50, Nm=100, sig2_n=1e-10)


def run(cfg: pend.PendulumConfig | None = None, backend: str = "generic",
        *, device: torch.device | str) -> dict[str, Any]:
    cfg = cfg or config()
    device = torch.device(device)
    data = pend.training_data(cfg, device)

    t0 = time.time()
    aux, _ = fit_auxgp(
        PER_SE_FREQ, data["Xp"], data["zp"], sig2n=cfg.sig2_n,
        nll_sig2n=1e-6, x0=(0.0, 0.0, -1.0),
        fixed_sig=2.0 * float(data["zp"].abs().max()) ** 2, delta=False)
    sgp, _ = fit_sympgp(
        PER_SE_FREQ, data["X"], data["z"], sig2n=cfg.sig2_n,
        x0=(-1.0, 0.0, -0.3),
        fixed_sig=2.0 * float(data["z"].abs().max()) ** 2)
    _sync(device)
    t_train = time.time() - t0

    freq = float(torch.abs(sgp.params[2]))
    q0, p0 = initial_conditions(cfg, device)
    t0 = time.time()
    traj = rollout(sgp, aux, q0, p0, cfg.nm, backend,
                   MapConfig(newton_tol=1e-12, newton_maxiter=10), iters=8)
    _sync(device)
    t_apply = time.time() - t0
    return dict(
        cfg=dataclasses.asdict(cfg),
        backend=backend,
        device=str(device),
        hyp=sgp.params.cpu().numpy(),
        freq=freq,
        period_ratio=0.5 / freq,
        training_error=float(sgp.training_error()),
        t_train=t_train,
        t_apply=t_apply,
        Eosc=energy_eosc(cfg, traj),
        traj=traj,
        models=(sgp, aux),
    )


def main(device: str = "cuda"):
    out = run(device=device)
    print(f"freq={out['freq']:.3f} periodicity (x 2pi) "
          f"{out['period_ratio']:.3f}")
    print(f"training error {out['training_error']:.1e}")
    print(f"Energy oscillation: {np.nanmean(out['Eosc']):.1e}")


if __name__ == "__main__":
    main()
