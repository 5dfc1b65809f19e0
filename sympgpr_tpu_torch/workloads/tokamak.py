"""Tokamak field-line map workload, single map over one toroidal turn or
the Split layout of ``nphmap`` sub-maps (PyTorch port of
``sympgpr_tpu/workloads/tokamak.py``).

Data generation and the GP fits (an aux and a symplectic GP per sub-map)
run in float64 on the given device.  The map is then iterated over the
test orbits by one of two backends:

* ``generic``: the float64 fast path (``maps.fast_apply``) with the masked
  early-exit Newton; the Split layout cycles the sub-maps
  (``apply_map_split``) and checks the loss boundary at the new q;
* ``kernel``: the fused rollout (``ops.cuda_step.rollout_model``) in
  float32 on deployment-conditioned models, cycling the sub-maps inside
  the kernel; on a CUDA device that is the hand-written kernel, on the CPU
  its plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

Tensor = torch.Tensor

from sympgpr_tpu_torch.eval import metrics
from sympgpr_tpu_torch.gp.train import fit_auxgp, fit_sympgp
from sympgpr_tpu_torch.kernels import PER_SE
from sympgpr_tpu_torch.maps.symplectic import (
    MapConfig,
    Trajectory,
    apply_map,
    apply_map_split,
    stack_models,
)
from sympgpr_tpu_torch.systems import tokamak as tk


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fit_one_split(q, p, Q, P, cfg: tk.TokamakConfig, optimizer: str):
    """Fit (aux, sympl) GPs for one sub-map with the reference's settings:
    aux log10 over (lq, lp, sig) from (-1, 0, 1) with NLL noise 1e-8;
    sympl linear over (lx, ly, sig) from (0.5, 0.5, 10), or with CMA-ES
    (sigma0 0.5, seed 0, the Split tokamak's optimizer) from (0.5, 2.5,
    2.0)."""
    cmaes = optimizer == "cmaes"
    opt_kwargs = dict(sigma0=0.5, seed=0) if cmaes else {}
    Xp = torch.stack([q, p], 1)
    aux, _ = fit_auxgp(
        PER_SE, Xp, P - p, sig2n=cfg.sig2_n, nll_sig2n=1e-8,
        x0=(-1.0, 0.0, 1.0), transform="log10", optimizer=optimizer,
        delta=True, **opt_kwargs)
    X = torch.stack([q, P], 1)
    z = torch.cat([p - P, Q - q])
    sgp, res = fit_sympgp(
        PER_SE, X, z, sig2n=cfg.sig2_n,
        x0=(0.5, 2.5, 2.0) if cmaes else (0.5, 0.5, 10.0),
        transform="linear", optimizer=optimizer, **opt_kwargs)
    return aux, sgp, res


def make_loss_fn(cfg: tk.TokamakConfig, use_new_q: bool):
    """Loss-region predicate: r from (P * 1e-2, q); lost when r > 0.5 or
    P < 0 (the Split layout checks at the new q and the sub-map's toroidal
    angle)."""
    M = cfg.nphmap

    def loss_fn(q_old, q_new, P, i):
        q = q_new if use_new_q else q_old
        ph = (2.0 * math.pi / M) * ((i + 1) % M) if M > 1 else 0.0
        r = tk.compute_r(P * 1e-2, q, ph, torch.full_like(P, 0.3))
        return (r > 0.5) | (P < 0.0)

    return loss_fn


def run(
    cfg: tk.TokamakConfig = tk.TokamakConfig(),
    optimizer: str = "lbfgs",
    nm: int | None = None,
    with_reference: bool = True,
    backend: str = "generic",
    *,
    device: torch.device | str,
) -> dict[str, Any]:
    """Generate data, fit, roll out the test orbits and score them.

    backend: 'generic' (float64 fast path) or 'kernel' (float32 fused
    rollout).  With ``cfg.nphmap`` = M > 1 each row of the trajectory is
    one sub-map step, M rows a turn.  ``with_reference`` integrates the
    plotting reference over ``nm // M`` turns (slow in eager mode) and the
    one-turn reference from the same ICs that gives ``gd``.
    """
    if backend not in ("generic", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    device = torch.device(device)
    nm = nm if nm is not None else cfg.nm
    M = cfg.nphmap

    data = tk.training_data(cfg, device)
    t0 = time.time()
    auxes, sgps, fits = [], [], []
    for m in range(M):
        aux, sgp, res = _fit_one_split(
            data["q"][:, m], data["p"][:, m], data["Q"][:, m],
            data["P"][:, m], cfg, optimizer)
        auxes.append(aux)
        sgps.append(sgp)
        fits.append(res)
    _sync(device)
    t_train = time.time() - t0

    (r0, th0), (r0p, th0p) = tk.test_initial_conditions(cfg)
    pth0, Q0 = tk.ics_to_pth(r0, th0, device)
    P0 = pth0 * cfg.momentum_scale

    t0 = time.time()
    traj = rollout(cfg, sgps, auxes, Q0, P0, nm, backend)
    _sync(device)
    t_apply = time.time() - t0

    out: dict[str, Any] = dict(
        cfg=dataclasses.asdict(cfg),
        optimizer=optimizer,
        backend=backend,
        device=str(device),
        hyps=[s.params.cpu().numpy() for s in sgps],
        sigs=[float(s.sig) for s in sgps],
        training_error=float(np.mean([float(s.training_error())
                                      for s in sgps])),
        t_train=t_train,
        t_apply=t_apply,
        nfev_sympl=[res.nfev for res in fits],
        traj=traj,
        n_lost=int(torch.isnan(traj.p[-1]).sum()),
        models=(sgps, auxes),
    )

    out["Eosc"] = section_eosc(cfg, traj)

    if with_reference:
        n_turns = max(nm // M, 1)
        ref = tk.reference_orbits(cfg, r0p, th0p, n_turns, device)
        out["ref_sections"] = ref[:: cfg.nph].cpu().numpy()
        out.update(one_turn_gd(cfg, traj, r0, th0, device))
    return out


def rollout(cfg: tk.TokamakConfig, sgps: list, auxes: list, Q0: Tensor,
            P0: Tensor, nm: int, backend: str) -> Trajectory:
    """Iterate the fitted (sub-)maps over the test orbits: the float64
    fast path (``generic``) or the float32 fused rollout (``kernel``)."""
    M = cfg.nphmap
    if backend == "kernel":
        from sympgpr_tpu_torch.ops import cuda_step

        # the Split tokamak cycles the M sub-maps inside the kernel and
        # checks the loss boundary at the new angle
        Qt, Pt = cuda_step.rollout_model(sgps, auxes, Q0, P0, nm,
                                         mod_q=2 * math.pi, loss_check=True,
                                         loss_at_new_q=(M > 1))
        return Trajectory(Qt, Pt, None)
    map_cfg = MapConfig(newton_tol=1e-12, newton_maxiter=20)
    if M == 1:
        return apply_map(sgps[0], auxes[0], Q0, P0, nm, map_cfg,
                         loss_pre=make_loss_fn(cfg, use_new_q=False))
    return apply_map_split(stack_models(sgps), stack_models(auxes), Q0, P0,
                           nm, M, map_cfg,
                           loss_post=make_loss_fn(cfg, use_new_q=True))


def section_eosc(cfg: tk.TokamakConfig, traj: Trajectory) -> np.ndarray:
    """Energy oscillation of each orbit over its sections (every
    ``cfg.nphmap``-th row: one point a turn)."""
    M = cfg.nphmap
    H = tk.field_energy(cfg.field, traj.q[::M], traj.p[::M])
    return metrics.energy_oscillation(H, dim=0).cpu().numpy()


def one_turn_gd(cfg: tk.TokamakConfig, traj: Trajectory, r0, th0,
                device: torch.device | str) -> dict[str, Any]:
    """gd of the first mapped section point (row ``cfg.nphmap``: one turn)
    vs the one-turn reference orbit from the same ICs."""
    M = cfg.nphmap
    ref_same = tk.reference_orbits(cfg, r0, th0, 1, device)
    qr = torch.remainder(ref_same[-1, :, 1], 2 * math.pi)
    pr = ref_same[-1, :, 0] * cfg.momentum_scale
    gd, stdgd = metrics.geometric_distance(traj.q[M], traj.p[M], qr, pr)
    return {"gd": gd.cpu().numpy(), "stdgd": float(stdgd)}


def main(device: str = "cuda"):
    out = run(device=device)
    print(f"training time {out['t_train']:.2f}s, "
          f"application time {out['t_apply']:.2f}s")
    print(f"training error {out['training_error']:.1e}")
    print(f"Energy oscillation: {np.nanmean(out['Eosc']):.1e}")
    if "gd" in out:
        print(f"Geometric distance: {np.nanmean(out['gd']):.1e} "
              f"± {out['stdgd']:.1e}")
    print(f"lost orbits: {out['n_lost']}/{out['cfg']['Ntest']}")


if __name__ == "__main__":
    main()
