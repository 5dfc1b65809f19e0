"""Tokamak field-line map workload, single map (PyTorch port of
``sympgpr_tpu/workloads/tokamak.py``).

Data generation and both GP fits run in float64 on the given device.  The
map is then iterated over the test orbits by one of two backends:

* ``generic``: the float64 fast path (``maps.fast_apply``) with the masked
  early-exit Newton;
* ``kernel``: the fused rollout (``ops.cuda_step.rollout_model``) in
  float32 on deployment-conditioned models; on a CUDA device that is the
  hand-written kernel, on the CPU its plain PyTorch version.
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
from sympgpr_tpu_torch.systems import tokamak as tk


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fit_one_split(q, p, Q, P, cfg: tk.TokamakConfig, optimizer: str):
    """Fit (aux, sympl) GPs for one sub-map with the reference's settings:
    aux log10 over (lq, lp, sig) from (-1, 0, 1) with NLL noise 1e-8;
    sympl linear over (lx, ly, sig) from (0.5, 0.5, 10)."""
    Xp = torch.stack([q, p], 1)
    aux, _ = fit_auxgp(
        PER_SE, Xp, P - p, sig2n=cfg.sig2_n, nll_sig2n=1e-8,
        x0=(-1.0, 0.0, 1.0), transform="log10", optimizer=optimizer,
        delta=True)
    X = torch.stack([q, P], 1)
    z = torch.cat([p - P, Q - q])
    sgp, res = fit_sympgp(
        PER_SE, X, z, sig2n=cfg.sig2_n, x0=(0.5, 0.5, 10.0),
        transform="linear", optimizer=optimizer)
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
    rollout).  ``with_reference`` integrates the plotting reference over
    ``nm`` turns (slow in eager mode) and the one-turn reference from the
    same ICs that gives ``gd``.
    """
    if cfg.nphmap != 1:
        raise NotImplementedError("the Split layout (nphmap > 1) is not "
                                  "ported yet")
    if backend not in ("generic", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    device = torch.device(device)
    nm = nm if nm is not None else cfg.nm

    data = tk.training_data(cfg, device)
    t0 = time.time()
    aux, sgp, _ = _fit_one_split(data["q"][:, 0], data["p"][:, 0],
                                 data["Q"][:, 0], data["P"][:, 0], cfg,
                                 optimizer)
    _sync(device)
    t_train = time.time() - t0

    (r0, th0), (r0p, th0p) = tk.test_initial_conditions(cfg)
    pth0, Q0 = tk.ics_to_pth(r0, th0, device)
    P0 = pth0 * cfg.momentum_scale

    t0 = time.time()
    if backend == "kernel":
        from sympgpr_tpu_torch.ops import cuda_step

        Qt, Pt = cuda_step.rollout_model(sgp, aux, Q0, P0, nm,
                                         mod_q=2 * math.pi, loss_check=True)
        traj = Trajectory(Qt, Pt, None)
    else:
        map_cfg = MapConfig(newton_tol=1e-12, newton_maxiter=20)
        traj = apply_map(sgp, aux, Q0, P0, nm, map_cfg,
                         loss_pre=make_loss_fn(cfg, use_new_q=False))
    _sync(device)
    t_apply = time.time() - t0

    out: dict[str, Any] = dict(
        cfg=dataclasses.asdict(cfg),
        optimizer=optimizer,
        backend=backend,
        device=str(device),
        hyps=[sgp.params.cpu().numpy()],
        sigs=[float(sgp.sig)],
        training_error=float(sgp.training_error()),
        t_train=t_train,
        t_apply=t_apply,
        traj=traj,
        n_lost=int(torch.isnan(traj.p[-1]).sum()),
        models=(sgp, aux),
    )

    H = tk.field_energy(cfg.field, traj.q, traj.p)
    out["Eosc"] = metrics.energy_oscillation(H, dim=0).cpu().numpy()

    if with_reference:
        n_turns = max(nm, 1)
        ref = tk.reference_orbits(cfg, r0p, th0p, n_turns, device)
        out["ref_sections"] = ref[:: cfg.nph].cpu().numpy()
        out.update(one_turn_gd(cfg, traj, r0, th0, device))
    return out


def one_turn_gd(cfg: tk.TokamakConfig, traj: Trajectory, r0, th0,
                device: torch.device | str) -> dict[str, Any]:
    """gd of the first mapped section point vs the one-turn reference
    orbit from the same ICs."""
    ref_same = tk.reference_orbits(cfg, r0, th0, 1, device)
    qr = torch.remainder(ref_same[-1, :, 1], 2 * math.pi)
    pr = ref_same[-1, :, 0] * cfg.momentum_scale
    gd, stdgd = metrics.geometric_distance(traj.q[1], traj.p[1], qr, pr)
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
