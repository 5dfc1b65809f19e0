"""Pendulum, semi-implicit symplectic GP map (PyTorch port of
``sympgpr_tpu/workloads/pendulum_implicit.py``).

Halton training data -> aux GP fit -> symplectic GP fit (L-BFGS over log10
lengthscales, sig fixed at 2 max|z|^2) -> rollout of the 15 test orbits ->
energy oscillation, the geometric distance of the first mapped point to a
one-map-time RK4 reference (``gd``) and a cost-matched symplectic-Euler
comparator (``Eosc_se``, ``t_apply_se``).  Backends as in
``workloads/standard_map.py``: ``generic`` (float64 fast path, early-exit
Newton) or ``kernel`` (float32 fused rollout, deployment jitter 1e-5).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from sympgpr_tpu_torch.eval import metrics
from sympgpr_tpu_torch.gp.train import fit_auxgp, fit_sympgp
from sympgpr_tpu_torch.kernels import PER_SE
from sympgpr_tpu_torch.maps.symplectic import MapConfig, Trajectory, apply_map
from sympgpr_tpu_torch.systems import pendulum as pend
from sympgpr_tpu_torch.workloads.tokamak import _sync


def initial_conditions(cfg: pend.PendulumConfig, device: torch.device):
    """The test ICs as float64 tensors on ``device``."""
    q0, p0 = pend.test_initial_conditions(cfg)
    f64 = dict(dtype=torch.float64, device=device)
    return torch.tensor(q0, **f64), torch.tensor(p0, **f64)


def rollout(sgp, aux, q0, p0, nm: int, backend: str, map_cfg: MapConfig,
            **kernel_kw) -> Trajectory:
    """The float64 fast path with ``map_cfg`` (``generic``) or the float32
    fused rollout with mod_q = 2 pi and deployment jitter 1e-5
    (``kernel``, further keywords to ``rollout_model``)."""
    if backend == "kernel":
        from sympgpr_tpu_torch.ops import cuda_step

        return Trajectory(*cuda_step.rollout_model(
            sgp, aux, q0, p0, nm, mod_q=2 * math.pi,
            deployment_jitter=1e-5, **kernel_kw))
    if backend != "generic":
        raise ValueError(f"unknown backend {backend!r}")
    return apply_map(sgp, aux, q0, p0, nm, map_cfg)


def energy_eosc(cfg: pend.PendulumConfig, traj: Trajectory) -> np.ndarray:
    H = metrics.pendulum_energy(traj.q, traj.p, cfg.U0)
    return metrics.energy_oscillation(H, dim=0).cpu().numpy()


def run(
    cfg: pend.PendulumConfig = pend.PendulumConfig(),
    *,
    with_reference: bool = True,
    with_comparator: bool = True,
    backend: str = "generic",
    device: torch.device | str,
) -> dict[str, Any]:
    """Fit, roll out nm rows and score (see the module docstring)."""
    if backend not in ("generic", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    device = torch.device(device)
    data = pend.training_data(cfg, device)

    t0 = time.time()
    # aux GP of the absolute P over (q, p) with the ordinary-GP NLL
    aux, _ = fit_auxgp(
        PER_SE, data["Xp"], data["zp"], sig2n=cfg.sig2_n, x0=(0.0, 0.0),
        fixed_sig=2.0 * float(data["zp"].abs().max()) ** 2, delta=False)
    sgp, sgp_res = fit_sympgp(
        PER_SE, data["X"], data["z"], sig2n=cfg.sig2_n, x0=(-1.0, -1.0),
        fixed_sig=2.0 * float(data["z"].abs().max()) ** 2,
        bounds=((-10, 1), (-10, 1)))
    _sync(device)
    t_train = time.time() - t0

    q0, p0 = initial_conditions(cfg, device)
    t0 = time.time()
    traj = rollout(sgp, aux, q0, p0, cfg.nm, backend,
                   MapConfig(newton_tol=1e-12, newton_maxiter=10))
    _sync(device)
    t_apply = time.time() - t0

    out: dict[str, Any] = dict(
        cfg=dataclasses.asdict(cfg),
        backend=backend,
        device=str(device),
        hyp_aux=aux.params.cpu().numpy(),
        hyp=sgp.params.cpu().numpy(),
        sig=float(sgp.sig),
        nll=sgp_res.fun,
        training_error=float(sgp.training_error()),
        t_train=t_train,
        t_apply=t_apply,
        Eosc=energy_eosc(cfg, traj),
        traj=traj,
        models=(sgp, aux),
    )

    if with_reference:
        # one map time per test IC, RK4 at 10x the reference's grid
        yref = pend.integrate_rk4(q0, p0, cfg.dtsymp * cfg.Nm, 10 * cfg.Nm)
        gd, stdgd = metrics.geometric_distance(
            traj.q[1], traj.p[1], torch.remainder(yref[:, 0], 2 * math.pi),
            yref[:, 1])
        out["gd"] = gd.cpu().numpy()
        out["stdgd"] = float(stdgd)

    if with_comparator:
        # symplectic Euler at matched cost: mf = 50 steps a map time
        mf = 50
        t0 = time.time()
        qs, ps = pend.symplectic_euler(q0, p0, cfg.dtsymp * cfg.Nm / mf,
                                       cfg.nm * mf)
        _sync(device)
        out["t_apply_se"] = time.time() - t0
        H = metrics.pendulum_energy(torch.remainder(qs, 2 * math.pi), ps,
                                    cfg.U0)
        out["Eosc_se"] = metrics.energy_oscillation(H, dim=0).cpu().numpy()
    return out


def main(device: str = "cuda"):
    out = run(device=device)
    print(f"training time: {out['t_train']:.2f} s")
    print(f"training error {out['training_error']:.1e}")
    print(f"Energy oscillation: {np.nanmean(out['Eosc']):.1e}")
    print(f"Geometric distance: {np.nanmean(out['gd']):.1e}")
    print(f"Sympl. Euler energy oscillation: {np.nanmean(out['Eosc_se']):.1e}")


if __name__ == "__main__":
    main()
