"""Henon-Heiles Poincare-section map (PyTorch port of
``sympgpr_tpu/workloads/henon_heiles.py``).

Successive section points (q2, p2), scaled by 1e2, of the training orbits
-> aux GP of P - p (SE x SE) and symplectic GP (SE x SE, L-BFGS over log10
lengthscales, sig fixed at 2 max|target|^2) -> rollout of the 37 test
orbits without any angle wrap -> the one-step MSE against the first
reference cut.  Backends: ``generic`` (float64 fast path, early-exit
Newton) or ``kernel`` (float32 fused rollout, deployment jitter 1e-3).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from sympgpr_tpu_torch.gp.train import fit_auxgp, fit_sympgp
from sympgpr_tpu_torch.kernels import SE_SE
from sympgpr_tpu_torch.maps.symplectic import MapConfig, Trajectory, apply_map
from sympgpr_tpu_torch.systems import henon_heiles as hh
from sympgpr_tpu_torch.workloads.tokamak import _sync


def run(
    cfg: hh.HenonConfig = hh.HenonConfig(),
    nm: int | None = None,
    *,
    with_reference: bool = True,
    backend: str = "generic",
    device: torch.device | str,
) -> dict[str, Any]:
    """Fit, roll out ``nm`` rows (``cfg.nm`` by default) and score (see the
    module docstring)."""
    if backend not in ("generic", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    nm = nm if nm is not None else cfg.nm
    device = torch.device(device)
    t0 = time.time()
    pts, _ = hh.section_pairs(cfg, hh.training_ics(cfg), 2, device)
    q, p = pts[0, :, 0], pts[0, :, 1]
    Q, P = pts[1, :, 0], pts[1, :, 1]
    X = torch.stack([q, P], 1)
    z = torch.cat([p - P, Q - q])
    Xp = torch.stack([q, p], 1)
    zp = P - p
    _sync(device)
    t_data = time.time() - t0

    t0 = time.time()
    aux, _ = fit_auxgp(
        SE_SE, Xp, zp, sig2n=cfg.sig2_n, x0=(0.0, 0.0),
        fixed_sig=2.0 * float(zp.abs().max()) ** 2,
        bounds=((-10, 1), (-10, 1)), delta=True)
    sgp, res = fit_sympgp(
        SE_SE, X, z, sig2n=cfg.sig2_n, x0=(-1.0, -1.0),
        fixed_sig=2.0 * float(z.abs().max()) ** 2,
        bounds=((-2, 2), (-2, 2)), tol=1e-8)
    _sync(device)
    t_train = time.time() - t0

    z0t = hh.test_ics(cfg)
    f64 = dict(dtype=torch.float64, device=device)
    q0 = torch.tensor(z0t[:, 1] * cfg.scale, **f64)
    p0 = torch.tensor(z0t[:, 3] * cfg.scale, **f64)
    t0 = time.time()
    if backend == "kernel":
        from sympgpr_tpu_torch.ops import cuda_step

        traj = Trajectory(*cuda_step.rollout_model(sgp, aux, q0, p0, nm,
                                                   mod_q=None))
    else:
        traj = apply_map(sgp, aux, q0, p0, nm,
                         MapConfig(mod_q=None, newton_tol=1e-12,
                                   newton_maxiter=20))
    _sync(device)
    t_apply = time.time() - t0

    out: dict[str, Any] = dict(
        cfg=dataclasses.asdict(cfg),
        backend=backend,
        device=str(device),
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
        ref_pts, _ = hh.section_pairs(cfg, z0t, min(nm, 8), device)
        _sync(device)
        out["t_reference"] = time.time() - t0
        out["ref_sections"] = ref_pts  # (cuts, Ntest, 2), scaled
        d = torch.stack([traj.q[1], traj.p[1]], -1)
        out["one_step_mse"] = float(
            torch.nanmean(torch.sum((d - ref_pts[0]) ** 2, -1) / 2))
    return out


def main(device: str = "cuda"):
    out = run(device=device)
    print(f"lq={out['hyp'][0]:.2f} lp={out['hyp'][1]:.2f}")
    print(f"training error {out['training_error']:.1e}")
    if "one_step_mse" in out:
        print(f"one-step MSE (scaled coords): {out['one_step_mse']:.1e}")
    print(f"train {out['t_train']:.2f}s apply {out['t_apply']:.2f}s")


if __name__ == "__main__":
    main()
