"""Chirikov standard map workload, implicit and explicit methods, and its
large-N form (PyTorch port of ``sympgpr_tpu/workloads/standard_map.py``).

``run`` (k = 2, N = 20, 30 test orbits): the implicit method fits an aux
GP and a per_se symplectic GP and iterates the implicit map with the
momentum wrapped into [0, 2 pi) and the unwrapped momentum (pdiff)
tracked; the explicit method fits the separable sum kernel sum_per_se
block by block (``fit_sympgp_separable``) and iterates Algorithm 2.  The
map is iterated by one of two backends:

* ``generic``: the float64 fast path (``maps.symplectic.apply_map``);
* ``kernel``: the fused rollout (``ops.cuda_step.rollout_model``) in
  float32 on deployment-conditioned models (jitter 1e-5), 8 Newton
  iterations, mod_p wrap and pdiff inside the kernel; on a CUDA device the
  hand-written kernel, on the CPU its plain PyTorch version.

``run_large`` trains at N in the thousands of exact map pairs on the
device (``gp.train.fit_sympgp_ondevice``: float32 through the covariance,
contraction, syrk and triangular-matmul kernels on CUDA, float64 on the
CPU) and rolls out through the kernel's mod_p / pdiff mode.  Both score
the one-step error against the exact map.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import torch

from sympgpr_tpu_torch.gp.train import (
    fit_auxgp,
    fit_sympgp,
    fit_sympgp_separable,
)
from sympgpr_tpu_torch.kernels import PER_SE, SUM_PER_SE
from sympgpr_tpu_torch.maps.symplectic import MapConfig, Trajectory, apply_map
from sympgpr_tpu_torch.systems import standard_map as sm
from sympgpr_tpu_torch.workloads.tokamak import _sync

TWO_PI = 2.0 * math.pi


def one_step_mse(Q1: torch.Tensor, P1: torch.Tensor, q0, p0,
                 k: float) -> float:
    """Mean squared minimum-image distance of the first mapped point
    (Q1, P1) to one exact map step from (q0, p0), both angles taken mod
    2 pi, halved over the two coordinates."""
    qr, pr = sm.iterate(q0, p0, k, 1)

    def d2(a, b):
        d = torch.remainder(a.double(), TWO_PI) - torch.remainder(b, TWO_PI)
        d = torch.minimum(d.abs(), TWO_PI - d.abs())
        return d**2

    return float(torch.mean(d2(Q1, qr[1]) + d2(P1, pr[1])) / 2)


def initial_conditions(cfg: sm.StandardMapConfig, device: torch.device):
    """The test ICs as float64 tensors on ``device``."""
    q0, p0 = sm.test_initial_conditions(cfg)
    f64 = dict(dtype=torch.float64, device=device)
    return torch.tensor(q0, **f64), torch.tensor(p0, **f64)


def run(
    cfg: sm.StandardMapConfig = sm.StandardMapConfig(),
    method: str = "implicit",
    backend: str = "generic",
    *,
    device: torch.device | str,
) -> dict[str, Any]:
    """Generate the pairs, fit, iterate the 30 test orbits nm - 1 times and
    score the first step against the exact map.

    method: 'implicit' (per_se, Newton map) or 'explicit' (sum_per_se,
    Algorithm 2); backend: 'generic' (float64 fast path) or 'kernel'
    (float32 fused rollout).  ``out["traj"]`` carries pdiff.
    """
    if backend not in ("generic", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    device = torch.device(device)
    data = sm.training_data(cfg, device)
    X, z = data["X"], data["z"]
    sig = 2.0 * float(z.abs().max()) ** 2

    t0 = time.time()
    if method == "implicit":
        # aux GP of P - p over (q, p), sig fixed
        sigp = 2.0 * float(data["zp"].abs().max()) ** 2
        aux, _ = fit_auxgp(
            PER_SE, data["Xp"], data["zp"], sig2n=cfg.sig2_n,
            x0=(-1.0, -1.0), fixed_sig=sigp, bounds=((-10, 1), (-10, 1)),
            delta=True)
        sgp, _ = fit_sympgp(
            PER_SE, X, z, sig2n=cfg.sig2_n, x0=(0.0, -1.0), fixed_sig=sig,
            bounds=((-2, 2), (-2, 2)), tol=1e-8)
        map_cfg = MapConfig(mod_q=TWO_PI, mod_p=TWO_PI, track_pdiff=True,
                            newton_tol=1e-12, newton_maxiter=30)
    elif method == "explicit":
        aux = None
        sgp, _ = fit_sympgp_separable(
            SUM_PER_SE, X, z, sig2n=cfg.sig2_n, nll_sig2n=1e-8,
            x0_q=(1.0,), x0_p=(1.0,), fixed_sig=sig)
        map_cfg = MapConfig(explicit=True, mod_q=None, mod_p=TWO_PI,
                            track_pdiff=True)
    else:
        raise ValueError(f"unknown method {method!r}")
    _sync(device)
    t_train = time.time() - t0

    q0, p0 = initial_conditions(cfg, device)
    t0 = time.time()
    if backend == "kernel":
        from sympgpr_tpu_torch.ops import cuda_step

        traj = Trajectory(*cuda_step.rollout_model(
            sgp, aux, q0, p0, cfg.nm, mod_q=map_cfg.mod_q,
            mod_p=map_cfg.mod_p, track_pdiff=True, iters=8,
            deployment_jitter=1e-5))
    else:
        traj = apply_map(sgp, aux, q0, p0, cfg.nm, map_cfg)
    _sync(device)
    t_apply = time.time() - t0

    q_ref, p_ref = sm.iterate(q0, p0, cfg.k, cfg.nm - 1)
    return dict(
        cfg=dataclasses.asdict(cfg),
        method=method,
        backend=backend,
        device=str(device),
        hyp=sgp.params.cpu().numpy(),
        sig=float(sgp.sig),
        training_error=float(sgp.training_error()),
        t_train=t_train,
        t_apply=t_apply,
        one_step_mse=one_step_mse(traj.q[1], traj.p[1], q0, p0, cfg.k),
        traj=traj,
        q_ref=q_ref.cpu().numpy(),
        p_ref=p_ref.cpu().numpy(),
        models=(sgp, aux),
    )


def run_large(
    n_train: int = 4096,
    nm: int = 200,
    steps: int = 60,
    lr: float = 5e-2,
    sig2n: float = 1e-2,
    aux_subsample: int = 512,
    k: float = 2.0,
    *,
    device: torch.device | str,
) -> dict[str, Any]:
    """Large-N standard map: exact pairs at N = ``n_train``, the aux GP on
    the first ``aux_subsample`` (float64, L-BFGS), the symplectic GP by
    ``steps`` Adam steps on the device (float32 on CUDA, float64 on the
    CPU), the 30 test orbits over ``nm`` rows through the fused rollout
    (mod_q = mod_p = 2 pi, pdiff, 8 Newton iterations, alpha as fitted),
    and the one-step error against the exact map.  ``out["models"]`` holds
    the fitted (SympGP, AuxGP); the other entries are plain numbers.
    """
    from sympgpr_tpu_torch.gp.train import fit_sympgp_ondevice
    from sympgpr_tpu_torch.ops import cuda_step

    device = torch.device(device)
    cfg = sm.StandardMapConfig(k=k, N=n_train, nm=nm)
    dtype = torch.float32 if device.type == "cuda" else torch.float64

    t0 = time.perf_counter()
    data = sm.training_data(cfg, device)
    na = min(aux_subsample, n_train)
    sigp = 2.0 * float(data["zp"].abs().max()) ** 2
    aux, _ = fit_auxgp(
        PER_SE, data["Xp"][:na], data["zp"][:na], sig2n=1e-10,
        x0=(-1.0, -1.0), fixed_sig=sigp, bounds=((-10, 1), (-10, 1)),
        delta=True)
    _sync(device)
    t_datagen = time.perf_counter() - t0

    X = data["X"].to(dtype)
    z = data["z"].to(dtype)
    model, hist, train_mse, timings = fit_sympgp_ondevice(
        PER_SE, X, z, sig2n=sig2n, steps=steps, lr=lr)

    q0, p0 = initial_conditions(cfg, device)
    t0 = time.perf_counter()
    Qt, Pt, Dt = cuda_step.rollout_model(
        model, aux, q0, p0, nm, mod_q=TWO_PI, mod_p=TWO_PI,
        track_pdiff=True, iters=8, deployment_jitter=None)
    _sync(device)
    t_apply = time.perf_counter() - t0

    return {
        "N": n_train,
        "k": k,
        "nm": nm,
        "dtype": str(dtype).removeprefix("torch."),
        "device": str(device),
        "sig2n": sig2n,
        "steps": steps,
        "t_datagen_s": t_datagen,
        **timings,
        "t_apply_s": t_apply,
        "nll_first": float(hist[0]),
        "nll_last": float(hist[-1]),
        "nll_decreased": bool(hist[-1] < hist[0]),
        "hyp": model.params.cpu().tolist() + [float(model.sig)],
        "train_mse": train_mse,
        "one_step_mse": one_step_mse(Qt[1], Pt[1], q0, p0, k),
        "finite_frac": float(torch.isfinite(Pt[-1]).double().mean()),
        "pdiff_finite": bool(torch.isfinite(Dt).all()),
        "n_test": len(q0),
        "models": (model, aux),
    }


def main(device: str = "cuda"):
    for method in ("implicit", "explicit"):
        out = run(method=method, device=device)
        print(f"[{method}] lq={out['hyp'][0]:.2f} lp={out['hyp'][1]:.2f} "
              f"training error {out['training_error']:.1e} "
              f"one-step MSE {out['one_step_mse']:.1e} "
              f"train {out['t_train']:.2f}s apply {out['t_apply']:.2f}s")


if __name__ == "__main__":
    main()
