"""Large-N tokamak: the field-line map trained at N in the thousands of real
section crossings (PyTorch port of ``sympgpr_tpu/workloads/tokamak_large.py``).

1. generate N section crossings with the float64 field-line integrator on
   the device (``systems/tokamak.py::training_data``);
2. fit the auxiliary warm-start GP on a Halton-prefix subsample, float64;
3. fit the symplectic GP at full N on the device: Adam over the
   closed-form value and gradient (``gp.train.fit_sympgp_ondevice``), in
   float32 on CUDA through the covariance, contraction, syrk and
   triangular-matmul kernels, in float64 on the CPU through their plain
   versions;
4. roll the reference's 30 test orbits out for nm turns through the fused
   rollout (``ops.cuda_step.rollout_model``, float32);
5. score: per-orbit energy oscillation, geometric distance of the first
   mapped section point to the float64 reference from the same ICs, lost
   orbits, training MSE;
6. optionally (``with_f64_rollout``) roll the same fitted models out in
   float64 through ``maps.symplectic.apply_map`` (the fast path with the
   early-exit Newton), which separates the map's own energy oscillation
   from the float32 rollout's summation noise.

Run: ``python -m sympgpr_tpu_torch run tokamak_large --n 4096 --device
cuda``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any

import numpy as np
import torch

from sympgpr_tpu_torch import profiling
from sympgpr_tpu_torch.eval import metrics
from sympgpr_tpu_torch.kernels import PER_SE
from sympgpr_tpu_torch.maps.symplectic import MapConfig, apply_map
from sympgpr_tpu_torch.systems import tokamak as tk
from sympgpr_tpu_torch.workloads.tokamak import _sync, make_loss_fn


def fit_sympgp_large(X: torch.Tensor, z: torch.Tensor, sig2n: float, theta0,
                     steps: int, lr: float, max_jitter_tries: int = 7):
    """PER_SE wrapper over ``gp.train.fit_sympgp_ondevice``."""
    from sympgpr_tpu_torch.gp.train import fit_sympgp_ondevice

    return fit_sympgp_ondevice(
        PER_SE, X, z, sig2n=sig2n, theta0=theta0, steps=steps, lr=lr,
        max_jitter_tries=max_jitter_tries)


def _float64(model):
    """A fitted SympGP or AuxGP with every tensor cast to float64."""
    return dataclasses.replace(model, **{
        f.name: getattr(model, f.name).to(torch.float64)
        for f in dataclasses.fields(model)
        if isinstance(getattr(model, f.name), torch.Tensor)})


def run(
    n_train: int = 4096,
    nm: int = 1000,
    steps: int = 40,
    lr: float = 5e-2,
    sig2n: float = 1e-2,
    aux_subsample: int = 512,
    theta0=(0.5, 2.5, 2.0),
    with_reference: bool = True,
    rollout_batch: int | None = None,
    compensated: bool = False,
    plots: str | None = None,
    with_f64_rollout: bool = False,
    *,
    device: torch.device | str,
) -> dict[str, Any]:
    """Data generation -> device fit -> fused rollout -> quality gates.

    float32 on CUDA, float64 on the CPU.  ``out["models"]`` holds the
    fitted (SympGP, AuxGP); the other entries are plain numbers.
    ``rollout_batch`` > 30 adds a throughput measurement of the rollout
    kernel alone, with the test ICs tiled to that batch.
    ``with_f64_rollout`` adds ``mean_Eosc_f64``, ``n_lost_f64`` and
    ``t_f64_rollout_s``: the fitted models cast to float64 on the run's
    device, rolled out for ``nm`` turns by ``apply_map``.  ``plots`` (a
    directory) writes the Poincare portrait of the rollout beside the
    float64 reference orbits from the same ICs over ``max(nm // 4, 1)``
    turns, one section point a turn, as
    ``tokamak_large_N{n_train}_portrait.png`` (``out["portrait"]``, and
    ``t_plots_s``: the reference is the eager midpoint integrator, so
    plots are opt-in).  ``compensated`` (a TPU workaround) is not ported
    and raises.
    """
    from sympgpr_tpu_torch.gp.train import fit_auxgp
    from sympgpr_tpu_torch.ops import cuda_step

    if compensated:
        raise NotImplementedError(
            "compensated double-float32 sums are not ported (a TPU "
            "workaround; float64 is native on the GPU)")
    if plots:
        # plots need matplotlib: fail before the fit and the reference
        import matplotlib  # noqa: F401
    device = torch.device(device)
    cfg = tk.TokamakConfig(N=n_train)
    dtype = torch.float32 if device.type == "cuda" else torch.float64

    # ---- 1. real section crossings, float64 on the device ----
    t0 = time.perf_counter()
    data = tk.training_data(cfg, device)
    _sync(device)
    t_datagen = time.perf_counter() - t0
    q, p = data["q"][:, 0], data["p"][:, 0]
    Q, P = data["Q"][:, 0], data["P"][:, 0]

    # ---- 2. aux warm-start GP on a Halton-prefix subsample, float64 ----
    na = min(aux_subsample, n_train)
    aux, _ = fit_auxgp(
        PER_SE, torch.stack([q[:na], p[:na]], 1), (P - p)[:na],
        sig2n=1e-10, nll_sig2n=1e-8, x0=(-1.0, 0.0, 1.0), transform="log10",
        optimizer="lbfgs", delta=True)

    # ---- 3. device fit of the symplectic GP at full N ----
    X = torch.stack([q, P], 1).to(dtype)
    z = torch.cat([p - P, Q - q]).to(dtype)
    model, hist, train_mse, timings = fit_sympgp_large(
        X, z, sig2n, theta0, steps, lr)

    # ---- 4. fused rollout of the reference test ICs ----
    (r0, th0), _ = tk.test_initial_conditions(cfg)
    pth0, q0 = tk.ics_to_pth(r0, th0, device)
    p0 = pth0 * cfg.momentum_scale
    t0 = time.perf_counter()
    # alpha is already solved at the deployment-scale jitter
    Qt, Pt = cuda_step.rollout_model(model, aux, q0, p0, nm,
                                     mod_q=2 * math.pi, loss_check=True,
                                     deployment_jitter=None)
    _sync(device)
    t_apply = time.perf_counter() - t0

    H = tk.field_energy(cfg.field, Qt, Pt)
    Eosc = metrics.energy_oscillation(H, dim=0).cpu().numpy()
    out: dict[str, Any] = {
        "N": n_train,
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
        "hist": hist.tolist(),
        "hyp": model.params.cpu().tolist() + [float(model.sig)],
        "train_mse": train_mse,
        "mean_Eosc": float(np.nanmean(Eosc)),
        "n_lost": int(torch.isnan(Pt[-1]).sum()),
        "n_test": len(r0),
        "models": (model, aux),
    }

    if with_reference:
        ref = tk.reference_orbits(cfg, r0, th0, 1, device)
        # the reference point in the trajectory's dtype, as the JAX package
        qr = torch.remainder(ref[-1, :, 1], 2 * math.pi).to(Qt.dtype)
        pr = (ref[-1, :, 0] * cfg.momentum_scale).to(Qt.dtype)
        gd, stdgd = metrics.geometric_distance(Qt[1], Pt[1], qr, pr)
        out["gd"] = float(np.nanmean(gd.cpu().numpy()))
        out["stdgd"] = float(stdgd)

    if with_f64_rollout:
        t0 = time.perf_counter()
        traj64 = apply_map(
            _float64(model), _float64(aux), q0.to(torch.float64),
            p0.to(torch.float64), nm,
            MapConfig(newton_tol=1e-12, newton_maxiter=20),
            loss_pre=make_loss_fn(cfg, use_new_q=False))
        _sync(device)
        out["t_f64_rollout_s"] = time.perf_counter() - t0
        H64 = tk.field_energy(cfg.field, traj64.q, traj64.p)
        out["mean_Eosc_f64"] = float(np.nanmean(
            metrics.energy_oscillation(H64, dim=0).cpu().numpy()))
        out["n_lost_f64"] = int(torch.isnan(traj64.p[-1]).sum())

    if plots:
        # the Poincare portrait against the float64 reference sections from
        # the same ICs, so the overlay panel compares structure directly
        from sympgpr_tpu_torch import plotting

        t0 = time.perf_counter()
        os.makedirs(plots, exist_ok=True)
        ref = tk.reference_orbits(cfg, r0, th0, max(nm // 4, 1), device)
        refs = ref[:: cfg.nph].cpu().numpy()  # one section point per turn
        out["portrait"] = plotting.portrait(
            np.mod(Qt.cpu().numpy(), 2 * np.pi), Pt.cpu().numpy(),
            np.mod(refs[:, :, 1], 2 * np.pi),
            refs[:, :, 0] * float(cfg.momentum_scale),
            path=os.path.join(plots,
                              f"tokamak_large_N{n_train}_portrait.png"),
            xlabel=r"$\theta$", ylabel=r"$p_\theta \cdot 10^2$",
            title=f"tokamak_large N={n_train}")
        out["t_plots_s"] = time.perf_counter() - t0

    if rollout_batch and rollout_batch > len(r0):
        reps = -(-rollout_batch // len(r0))
        qb = q0.repeat(reps)[:rollout_batch].to(torch.float32).contiguous()
        pb = p0.repeat(reps)[:rollout_batch].to(torch.float32).contiguous()
        nmb = min(nm, 256)
        pm = cuda_step.pack_models(model, aux, mod_q=2 * math.pi)
        ms = profiling.best_ms(lambda: cuda_step.rollout_in_kernel(
            pm, qb, pb, nmb, loss_check=True), device=device)
        out["rollout_batch"] = rollout_batch
        out["rollout_ms"] = ms
        out["rollout_steps_per_s"] = (nmb - 1) * rollout_batch / (ms * 1e-3)
    return out


def main(device: str = "cuda"):
    import json

    out = run(device=device)
    out.pop("models")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
