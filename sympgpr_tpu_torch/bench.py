"""Headline benchmark of the port: the tokamak fit and the orbit rollout
(PyTorch port of the JAX package's root ``bench.py``, whose stages it runs
in order at its sizes).

    python -m sympgpr_tpu_torch bench --device cuda

Measures the throughput of the learned map's application (orbit-steps a
second) on the device and compares it with the CPU baseline of the
reference's algorithmic structure (per-orbit Python loops and a scipy
Newton solve a step, ``baselines/reference_cpu.py``).  Stages, each a
function of its sizes:

1. ``fit``: the N = 80 tokamak maps (``workloads/tokamak.py::
   _fit_one_split``, L-BFGS) in float64 on the device (the JAX package fits
   on the host, a TPU workaround);
2. ``cpu_baseline``: ``reference_cpu.applymap`` over ``nm_base`` steps;
3. on the card, ``kernel_rollouts``: the float32 deployment
   (``for_deployment(1e-3)``, ``ops/cuda_step.py::pack_models``), the
   reference size (30 orbits x 10,000 steps, the loss check at the old q)
   in one ``rollout_in_kernel`` launch, not chunked, and the throughput
   batch (32768 x 1000), each best of 3 (``profiling.best_ms``); on the CPU
   (``--device cpu``), ``cpu_rollouts``: the branch the JAX file takes off
   the TPU, float64 fast-path rollouts of 30 x 10,000 and 4096 x 1000
   (``maps/symplectic.py::apply_map``);
4. the reference-size run's lost orbits and mean energy oscillation
   (``mean_eosc``; the JAX file computes it and prints it nowhere, here it
   goes to standard error);
5. on the card only: ``workloads/large_n.py::measure`` at
   ``SYMPGPR_BENCH_LARGE_N`` (4096), ``workloads/tokamak_large.py::run`` at
   ``SYMPGPR_BENCH_TOK_LARGE_N`` / ``_STEPS`` (4096 / 60; nm 1000, sig2n
   1e-3, rollout batch 4096) and ``nuts_samples_per_s``: NUTS (8 chains x
   128 draws, 64 warm-up transitions, step 0.05, depth 6, seed 1) over the
   fitted map's hyperposterior in float32 (``gp/hmc.py::nll_logprob`` is
   the JAX file's ``nll_logprob(..., nll)``).  The JAX file's first NUTS
   call compiles; here a call of 2 warm-up and 2 draws takes its place
   (allocations, the first cuSOLVER handle), as torch compiles nothing.

Prints the detail (the JAX file's keys) and then, as the last line, the
headline ``{"metric", "value", "unit", "vs_baseline"}``: only the tail of a
run's output may be kept.  The launches of the hand-written kernels and
the mean Eosc go to standard error as one JSON line.

Not ported: the watchdog that falls back to the CPU when the accelerator
does not answer, and the wrappers that turn a failed stage into a string
in the detail: a failed stage fails the run.  ``rollout_mxu_reduce_steps_
per_s`` stays as a key with ``null``: the MXU-reduction rollout is a TPU
experiment.  ``compile_cache_dir`` is the kernels' build directory.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch

from sympgpr_tpu_torch import profiling
from sympgpr_tpu_torch.baselines import reference_cpu as refcpu
from sympgpr_tpu_torch.eval.metrics import energy_oscillation
from sympgpr_tpu_torch.gp import hmc, nuts
from sympgpr_tpu_torch.maps.symplectic import MapConfig, apply_map
from sympgpr_tpu_torch.ops import _build, cuda_step
from sympgpr_tpu_torch.systems import tokamak as tk
from sympgpr_tpu_torch.workloads import large_n, tokamak_large
from sympgpr_tpu_torch.workloads.tokamak import (
    _fit_one_split,
    _sync,
    make_loss_fn,
)

HEADLINE = "tokamak_rollout_orbit_steps_per_s"


def initial_conditions(cfg: tk.TokamakConfig, device: torch.device):
    """The 30 test orbits' (q0, p0) as float64 tensors on ``device``."""
    (r0, th0), _ = tk.test_initial_conditions(cfg)
    pth0, q0 = tk.ics_to_pth(r0, th0, device)
    return q0, pth0 * float(cfg.momentum_scale)


def fit(cfg: tk.TokamakConfig, device: torch.device):
    """(aux, sgp, seconds) of the tokamak's one-turn maps, float64 on the
    device."""
    data = tk.training_data(cfg, device)
    t0 = time.time()
    aux, sgp, _ = _fit_one_split(data["q"][:, 0], data["p"][:, 0],
                                 data["Q"][:, 0], data["P"][:, 0], cfg,
                                 "lbfgs")
    _sync(device)
    return aux, sgp, time.time() - t0


def cpu_baseline(sgp, aux, q0, p0, nm_base: int = 40) -> float:
    """Orbit-steps a second of the reference-style numpy rollout (loss
    check at the old q) over ``nm_base`` steps of the test orbits."""
    m = refcpu.ReferenceStyleModel(
        X=sgp.X.cpu().numpy(), z=sgp.z.cpu().numpy(),
        lx=float(sgp.params[0]), ly=float(sgp.params[1]),
        sig=float(sgp.sig), sig2n=float(sgp.sig2n),
        Xp=aux.X.cpu().numpy(), zp=aux.z.cpu().numpy(),
        lxp=float(aux.params[0]), lyp=float(aux.params[1]),
        sigp=float(aux.sig), aux_delta=True)
    q, p = q0.cpu().numpy(), p0.cpu().numpy()
    t0 = time.time()
    refcpu.applymap(m, nm_base, q, p, loss_fn=refcpu.tokamak_loss_fn())
    return (nm_base - 1) * len(q) / (time.time() - t0)


def _tiled(x: torch.Tensor, B: int, dtype: torch.dtype) -> torch.Tensor:
    return x.repeat(-(-B // len(x)))[:B].to(dtype).contiguous()


def kernel_rollouts(sgp, aux, q0, p0, *, ref_steps: int = 10_000,
                    batch: int = 32768, batch_steps: int = 1000):
    """The float32 deployment through the fused rollout, the loss checked
    at the old q: (reference-size orbit-steps/s, its (Q, P), throughput
    orbit-steps/s).  Each time is the best of 3 single launches after a
    warm-up (``profiling.best_ms``; on CPU tensors the plain version)."""
    pm = cuda_step.pack_models(sgp.for_deployment(1e-3),
                               aux.for_deployment(1e-3), mod_q=2 * math.pi)
    device = q0.device
    q, p = (x.to(torch.float32).contiguous() for x in (q0, p0))
    out = {}

    def ref_run():
        out["traj"] = cuda_step.rollout_in_kernel(pm, q, p, ref_steps,
                                                  loss_check=True)

    ms = profiling.best_ms(ref_run, device=device)
    ref = (ref_steps - 1) * len(q) / (ms * 1e-3)
    qb, pb = _tiled(q0, batch, torch.float32), _tiled(p0, batch,
                                                      torch.float32)
    ms = profiling.best_ms(lambda: cuda_step.rollout_in_kernel(
        pm, qb, pb, batch_steps, loss_check=True), device=device)
    return ref, out["traj"], (batch_steps - 1) * batch / (ms * 1e-3)


def cpu_rollouts(sgp, aux, q0, p0, cfg: tk.TokamakConfig, *,
                 ref_steps: int = 10_000, batch: int = 4096,
                 batch_steps: int = 1000):
    """The JAX file's branch off the TPU: float64 fast-path rollouts
    (Newton to 1e-12, at most 8 iterations, the loss check at the old q)
    of the test orbits over ``ref_steps`` and of ``batch`` tiled orbits
    over ``batch_steps``, each timed once after a warm-up call: (reference
    orbit-steps/s, its (Q, P), throughput orbit-steps/s)."""
    mcfg = MapConfig(newton_tol=1e-12, newton_maxiter=8)
    lf = make_loss_fn(cfg, use_new_q=False)
    out = {}

    def rollout(q, p, nm):
        out["traj"] = apply_map(sgp, aux, q, p, nm, mcfg, loss_pre=lf)

    ms = profiling.best_ms(lambda: rollout(q0, p0, ref_steps), reps=1,
                           device=q0.device)
    ref = (ref_steps - 1) * len(q0) / (ms * 1e-3)
    traj = (out["traj"].q, out["traj"].p)
    qb, pb = _tiled(q0, batch, torch.float64), _tiled(p0, batch,
                                                      torch.float64)
    ms = profiling.best_ms(lambda: rollout(qb, pb, batch_steps), reps=1,
                           device=q0.device)
    return ref, traj, (batch_steps - 1) * batch / (ms * 1e-3)


def mean_eosc(cfg: tk.TokamakConfig, Q: torch.Tensor,
              P: torch.Tensor) -> float:
    """Mean over orbits of the field energy's oscillation along a
    trajectory (float64; lost samples left out)."""
    H = tk.field_energy(cfg.field, Q.double(), P.double())
    return float(np.nanmean(energy_oscillation(H, axis=0).cpu().numpy()))


def nuts_samples_per_s(sgp, device: torch.device, *, chains: int = 8,
                       draws: int = 128, warmup: int = 64,
                       max_depth: int = 6):
    """Draws a second of NUTS over the fitted map's log10 hyperparameters
    (sig2n 1e-8, float32, from 0.02 k for chain k, step 0.05, seed 1),
    after a call of 2 warm-up transitions and 2 draws (seed 0); and the
    run's context."""
    f32 = dict(dtype=torch.float32, device=device)
    lp = hmc.nll_logprob(sgp.kernel, sgp.X.to(**f32), sgp.z.to(**f32), 1e-8)
    x0s = torch.tensor(np.zeros((chains, 3))
                       + 0.02 * np.arange(chains)[:, None], **f32)
    kw = dict(step_size=0.05, max_depth=max_depth)
    nuts.sample_nuts(lp, x0s, 2, n_warmup=2, seed=0, **kw)
    _sync(device)
    t0 = time.time()
    r = nuts.sample_nuts(lp, x0s, draws, n_warmup=warmup, seed=1, **kw)
    float(torch.sum(r.samples))
    sps = round(chains * draws / (time.time() - t0), 1)
    return sps, {"N_train": int(sgp.X.shape[0]), "chains": chains,
                 "draws": draws, "warmup": warmup, "max_depth": max_depth}


def run(device: torch.device | str = "cuda", *, nm_base: int = 40,
        ref_steps: int = 10_000, batch: int | None = None,
        batch_steps: int = 1000):
    """All stages on ``device``: the detail and headline dicts, and the
    reference-size run (``Q``, ``P`` and its ``mean_Eosc``).  ``batch``
    defaults to the JAX file's 32768 on the card and 4096 on the CPU; the
    large-N stages' sizes come from its environment variables."""
    t_start = time.time()
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("bench on cuda: no CUDA device is available")
    cfg = tk.TokamakConfig()
    aux, sgp, t_fit = fit(cfg, device)
    q0, p0 = initial_conditions(cfg, device)
    base = cpu_baseline(sgp, aux, q0, p0, nm_base)
    if on_card:
        ref, traj, big = kernel_rollouts(
            sgp, aux, q0, p0, ref_steps=ref_steps, batch=batch or 32768,
            batch_steps=batch_steps)
    else:
        ref, traj, big = cpu_rollouts(
            sgp, aux, q0, p0, cfg, ref_steps=ref_steps, batch=batch or 4096,
            batch_steps=batch_steps)
    n_lost = int(torch.isnan(traj[1][-1]).sum())
    ref_run = {"Q": traj[0], "P": traj[1], "mean_Eosc": mean_eosc(cfg, *traj)}
    large = tok_large = nuts_sps = nuts_ctx = None
    if on_card:
        env = os.environ.get
        large = large_n.measure(N=int(env("SYMPGPR_BENCH_LARGE_N", 4096)),
                                device=device)
        tok_large = tokamak_large.run(
            n_train=int(env("SYMPGPR_BENCH_TOK_LARGE_N", 4096)), nm=1000,
            steps=int(env("SYMPGPR_BENCH_TOK_LARGE_STEPS", 60)), sig2n=1e-3,
            rollout_batch=4096, device=device)
        tok_large.pop("models")
        nuts_sps, nuts_ctx = nuts_samples_per_s(sgp, device)
    headline = {"metric": HEADLINE, "value": round(big, 1),
                "unit": "orbit-steps/s", "vs_baseline": round(big / base, 2)}
    detail = {
        "device": (f"{device} ({torch.cuda.get_device_name(device)})"
                   if on_card else str(device)),
        "dtype": "float32" if on_card else "float64",
        "fit_s": round(t_fit, 2),
        "cpu_baseline_steps_per_s": round(base, 1),
        "ref_size_steps_per_s": round(ref, 1),
        "ref_size_speedup": round(ref / base, 2),
        "lost_orbits_10k": n_lost,
        "rollout_mxu_reduce_steps_per_s": None,
        "large_n": large,
        "tokamak_large": tok_large,
        "nuts_samples_per_s": nuts_sps,
        "nuts_context": nuts_ctx,
        "compile_cache_dir": str(_build.BUILD_DIR),
        "total_bench_s": round(time.time() - t_start, 1),
    }
    return detail, headline, ref_run


def main(device: torch.device | str = "cuda", **sizes) -> dict:
    """Run the stages; print the detail, then the headline as the last
    line of standard output (the kernels' launches and the reference-size
    run's mean Eosc on standard error)."""
    profiling.launch_counts(zero=True)
    detail, headline, ref_run = run(device, **sizes)
    print(json.dumps({"detail": detail}), flush=True)
    print(json.dumps({"launches": profiling.launch_counts(),
                      "ref_size_mean_Eosc": ref_run["mean_Eosc"]}),
          file=sys.stderr, flush=True)
    print(json.dumps(headline), flush=True)
    return headline
