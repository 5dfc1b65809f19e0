"""Perturbed pendulum, stroboscopic Poincare map (PyTorch port of
``sympgpr_tpu/workloads/pert_pendulum.py``).

Disc training data -> aux GP of the absolute P and symplectic GP, both
fitted by L-BFGS over *linear* hyperparameters from (0.5, 0.5) with sig
fixed at 2 max|target|^2 -> rollout of the 30 line ICs with q wrapped mod 2
pi -> the one-step MSE against the RK4 stroboscope (the angle difference
taken on the circle).  Backends as in ``workloads/pendulum_implicit.py``:
``generic`` (float64 fast path, early-exit Newton) or ``kernel`` (float32
fused rollout, deployment jitter 1e-5).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import torch

from sympgpr_tpu_torch.gp.train import fit_auxgp, fit_sympgp
from sympgpr_tpu_torch.kernels import PER_SE
from sympgpr_tpu_torch.maps.symplectic import MapConfig
from sympgpr_tpu_torch.systems import pert_pendulum as sys_pp
from sympgpr_tpu_torch.workloads.pendulum_implicit import rollout
from sympgpr_tpu_torch.workloads.tokamak import _sync


def run(
    cfg: sys_pp.PertPendulumConfig = sys_pp.PertPendulumConfig(),
    *,
    with_reference: bool = True,
    backend: str = "generic",
    device: torch.device | str,
) -> dict[str, Any]:
    """Fit, roll out nm rows and score (see the module docstring)."""
    if backend not in ("generic", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    device = torch.device(device)
    t0 = time.time()
    data = sys_pp.training_data(cfg, device)
    _sync(device)
    t_data = time.time() - t0

    t0 = time.time()
    aux, _ = fit_auxgp(
        PER_SE, data["Xp"], data["zp"], sig2n=cfg.sig2_n, x0=(0.5, 0.5),
        fixed_sig=2.0 * float(data["zp"].abs().max()) ** 2,
        transform="linear", delta=False)
    sgp, res = fit_sympgp(
        PER_SE, data["X"], data["z"], sig2n=cfg.sig2_n, x0=(0.5, 0.5),
        fixed_sig=2.0 * float(data["z"].abs().max()) ** 2,
        transform="linear")
    _sync(device)
    t_train = time.time() - t0

    f64 = dict(dtype=torch.float64, device=device)
    q0, p0 = (torch.tensor(x, **f64)
              for x in sys_pp.test_initial_conditions(cfg))
    t0 = time.time()
    traj = rollout(sgp, aux, q0, p0, cfg.nm, backend,
                   MapConfig(newton_tol=1e-12, newton_maxiter=20))
    _sync(device)
    t_apply = time.time() - t0

    out: dict[str, Any] = dict(
        cfg=dataclasses.asdict(cfg),
        backend=backend,
        device=str(device),
        n_train=data["n_data"],
        hyp_aux=aux.params.cpu().numpy(),
        hyp=sgp.params.cpu().numpy(),
        nll=res.fun,
        training_error=float(sgp.training_error()),
        t_data=t_data,
        t_train=t_train,
        t_apply=t_apply,
        traj=traj,
        models=(sgp, aux),
    )
    if with_reference:
        t0 = time.time()
        q_ref, p_ref = sys_pp.reference_orbits(cfg, q0, p0, cfg.nm)
        _sync(device)
        out["t_reference"] = time.time() - t0
        out["q_ref"], out["p_ref"] = q_ref, p_ref
        dq = traj.q[1] - torch.remainder(q_ref[1], 2 * math.pi)
        dq = torch.minimum(dq.abs(), 2 * math.pi - dq.abs())
        dp = traj.p[1] - p_ref[1]
        out["one_step_mse"] = float(torch.mean(dq**2 + dp**2) / 2)
    return out


def main(device: str = "cuda"):
    out = run(device=device)
    print(f"Training data: {out['n_train']}")
    print(f"lq={out['hyp'][0]:.2f} lp={out['hyp'][1]:.2f}")
    print(f"training error {out['training_error']:.1e}")
    if "one_step_mse" in out:
        print(f"one-step MSE vs RK reference: {out['one_step_mse']:.1e}")
    print(f"train {out['t_train']:.2f}s apply {out['t_apply']:.2f}s")


if __name__ == "__main__":
    main()
