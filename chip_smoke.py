#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``sympgpr_tpu_torch``).

Builds the hand-written CUDA rollout kernel from the checkout's sources,
drives the tokamak workload through it on the card at the reference
configuration (N=80 training crossings, 30 test orbits, nm=1000), holds
the kernel against its plain PyTorch version, and times both.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Prints one JSON line per phase.  Any failure raises: the exit code is
non-zero and no ``"ok"`` line is printed.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports no JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCE = "sympgpr_tpu_torch/csrc/rollout_step.cu"
REPLACES = "sympgpr_tpu/ops/pallas_step.py:259"  # def _rollout_kernel
BENCH_ORBITS = 32768  # the orbit-batched size of the JAX package's bench
NM = 1000

# gates of the main path (tests/test_workloads.py test_tokamak_single and
# test_tokamak_pallas_backend at the reference size)
GATE_TRAIN_ERR = 1e-12
GATE_MEDIAN_GD = 2e-2
GATE_LOST = 10
# RESULTS.md row "05 tokamak (N=80, nm=1000)", float64 on the CPU
RESULTS_ROW = {"train_err": 1.9e-20, "Eosc": 8.2e-3, "gd": 2.5e-4, "lost": 0}

# kernel vs plain version on the card
ATOL_F64 = 1e-9  # every step of 100, float64: ~1e-15 per step on regular orbits
# float32 at steps 1-2: each float32 version is within 3e-5 of the float64
# rollout at step 2 (plain version on the CPU at this size), so two
# float32 versions agree within 2 x 3e-5; 1e-4 leaves margin
ATOL_F32 = 1e-4
EOSC_RTOL_F32 = 0.1  # mean Eosc over 1000 steps, float32 (decoherent orbits)
LOST_SLACK_F32 = 1


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=float), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    return dev, smi


def phase_build() -> None:
    from sympgpr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load("rollout_step")
    log = _build.library_path("rollout_step").with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas[:12])


def phase_main_kernel(dev):
    from sympgpr_tpu_torch.ops import cuda_step
    from sympgpr_tpu_torch.systems import tokamak as tk
    from sympgpr_tpu_torch.workloads import tokamak as wl

    cfg = tk.TokamakConfig()
    cuda_step.LAUNCHES = 0
    out = wl.run(cfg, nm=NM, backend="kernel", with_reference=False,
                 device=dev)
    launches = cuda_step.LAUNCHES
    (r0, th0), _ = tk.test_initial_conditions(cfg)
    out.update(wl.one_turn_gd(cfg, out["traj"], r0, th0, dev))
    res = dict(training_error=out["training_error"],
               mean_gd=float(np.nanmean(out["gd"])),
               median_gd=float(np.nanmedian(out["gd"])),
               mean_Eosc=float(np.nanmean(out["Eosc"])),
               n_lost=out["n_lost"], t_train=out["t_train"],
               t_apply=out["t_apply"], launches=launches,
               hyps=out["hyps"][0].tolist(), sig=out["sigs"][0],
               dtype=str(out["traj"].q.dtype),
               shape=list(out["traj"].q.shape))
    emit("main_kernel", **res)
    assert launches > 0, "the main path launched no rollout kernel"
    assert res["training_error"] < GATE_TRAIN_ERR, res
    assert res["median_gd"] < GATE_MEDIAN_GD, res
    assert res["n_lost"] <= GATE_LOST, res
    assert np.isfinite(out["traj"].q[:, ~torch.isnan(out["traj"].p[-1])]
                       .cpu().numpy()).all()
    assert out["traj"].q.device.type == "cuda"
    return out, launches


def phase_main_generic(dev):
    from sympgpr_tpu_torch.systems import tokamak as tk
    from sympgpr_tpu_torch.workloads import tokamak as wl

    cfg = tk.TokamakConfig()
    out = wl.run(cfg, nm=NM, backend="generic", with_reference=False,
                 device=dev)
    (r0, th0), _ = tk.test_initial_conditions(cfg)
    out.update(wl.one_turn_gd(cfg, out["traj"], r0, th0, dev))
    res = dict(training_error=out["training_error"],
               mean_gd=float(np.nanmean(out["gd"])),
               mean_Eosc=float(np.nanmean(out["Eosc"])),
               n_lost=out["n_lost"], t_train=out["t_train"],
               t_apply=out["t_apply"], results_row=RESULTS_ROW)
    emit("main_generic", **res)
    assert out["traj"].q.dtype == torch.float64
    assert res["training_error"] < GATE_TRAIN_ERR, res
    assert res["n_lost"] == RESULTS_ROW["lost"], res
    for k, ref in (("mean_gd", RESULTS_ROW["gd"]),
                   ("mean_Eosc", RESULTS_ROW["Eosc"])):
        assert 0.5 <= res[k] / ref <= 2.0, (k, res[k], ref)


def _ics(dev, dtype, reps=1):
    from sympgpr_tpu_torch.systems import tokamak as tk

    (r0, th0), _ = tk.test_initial_conditions(tk.TokamakConfig())
    pth0, q0 = tk.ics_to_pth(np.tile(r0, reps), np.tile(th0, reps), dev)
    return q0.to(dtype).contiguous(), (pth0 * 1e2).to(dtype).contiguous()


def _eosc_lost(Q, P):
    from sympgpr_tpu_torch.eval import metrics
    from sympgpr_tpu_torch.systems import tokamak as tk

    H = tk.field_energy(tk.TokamakConfig().field, Q, P)
    return (float(np.nanmean(metrics.energy_oscillation(H).cpu().numpy())),
            int(torch.isnan(P[-1]).sum()))


def _max_diff(a, b) -> float:
    """max |a - b| where positions NaN in both count 0 and NaN in one
    count inf (a lost orbit must be lost in both)."""
    d = (a - b).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
    return float(d.nan_to_num(math.inf).max())


def _time(fn, reps=3):
    """Best of ``reps`` after one warm-up, in ms (CUDA events)."""
    fn()
    sync()
    best = math.inf
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        sync()
        best = min(best, a.elapsed_time(b))
    return best


def phase_kernel_vs_plain(dev, models):
    """The kernel against rollout_reference on the phase-3 models."""
    from sympgpr_tpu_torch.ops import cuda_step as cs

    sgp, aux = models
    sd, ad = sgp.for_deployment(1e-3), aux.for_deployment(1e-3)

    pm64 = cs.pack_models(sd, ad, mod_q=2 * math.pi, dtype=torch.float64)
    q0, p0 = _ics(dev, torch.float64)
    Qk, Pk = cs.rollout_in_kernel(pm64, q0, p0, 100, loss_check=True)
    sync()
    Qr, Pr = cs.rollout_reference(pm64, q0, p0, 100, loss_check=True)
    err64 = max(_max_diff(Qk, Qr), _max_diff(Pk, Pr))
    nan_same64 = bool(torch.equal(torch.isnan(Pk), torch.isnan(Pr)))

    pm32 = cs.pack_models(sd, ad, mod_q=2 * math.pi)
    q0, p0 = _ics(dev, torch.float32)
    Qk, Pk = cs.rollout_in_kernel(pm32, q0, p0, NM, loss_check=True)
    sync()
    Qr, Pr = cs.rollout_reference(pm32, q0, p0, NM, loss_check=True)
    err32 = max(_max_diff(Qk[1:3], Qr[1:3]), _max_diff(Pk[1:3], Pr[1:3]))
    eosc_k, lost_k = _eosc_lost(Qk, Pk)
    eosc_r, lost_r = _eosc_lost(Qr, Pr)

    ms = _time(lambda: cs.rollout_in_kernel(pm32, q0, p0, NM,
                                            loss_check=True))
    plain_ms = _time(lambda: cs.rollout_reference(pm32, q0, p0, NM,
                                                  loss_check=True))
    res = dict(f64_max_abs_err_100_steps=err64, f64_atol=ATOL_F64,
               f64_nan_pattern_equal=nan_same64,
               f32_max_abs_err_steps_1_2=err32, f32_atol=ATOL_F32,
               f32_mean_Eosc_kernel=eosc_k, f32_mean_Eosc_plain=eosc_r,
               f32_lost_kernel=lost_k, f32_lost_plain=lost_r,
               ms_30x1000_f32=ms, plain_ms_30x1000_f32=plain_ms)
    emit("kernel_vs_plain", **res)
    assert nan_same64 and err64 <= ATOL_F64, res
    assert err32 <= ATOL_F32, res
    assert abs(eosc_k - eosc_r) <= EOSC_RTOL_F32 * eosc_r, res
    assert abs(lost_k - lost_r) <= LOST_SLACK_F32, res
    return pm32, err32, ms, plain_ms


def phase_throughput(dev, pm32):
    from sympgpr_tpu_torch.ops import cuda_step as cs

    reps = math.ceil(BENCH_ORBITS / 30)
    q0, p0 = _ics(dev, torch.float32, reps)
    q0, p0 = q0[:BENCH_ORBITS].contiguous(), p0[:BENCH_ORBITS].contiguous()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = _time(lambda: cs.rollout_in_kernel(pm32, q0, p0, NM,
                                            loss_check=True))
    peak_kernel = torch.cuda.max_memory_allocated(dev)
    Qk, Pk = cs.rollout_in_kernel(pm32, q0, p0, NM, loss_check=True)
    sync()
    finite = bool(torch.isfinite(Qk[:, ~torch.isnan(Pk[-1])]).all())
    plain_ms = _time(lambda: cs.rollout_reference(pm32, q0, p0, NM,
                                                  loss_check=True))
    steps = (NM - 1) * BENCH_ORBITS
    res = dict(orbits=BENCH_ORBITS, nm=NM, dtype="float32",
               kernel_ms=ms, plain_ms=plain_ms,
               kernel_orbit_steps_per_s=steps / (ms * 1e-3),
               plain_orbit_steps_per_s=steps / (plain_ms * 1e-3),
               kernel_over_plain=plain_ms / ms,
               peak_mem_bytes_kernel=peak_kernel,
               lost=int(torch.isnan(Pk[-1]).sum()), finite=finite)
    emit("throughput", **res)
    assert finite, res


def main() -> None:
    dev, smi = phase_device()
    phase_build()
    out, launches = phase_main_kernel(dev)
    phase_main_generic(dev)
    pm32, err32, ms, plain_ms = phase_kernel_vs_plain(dev, out["models"])
    phase_throughput(dev, pm32)
    print(json.dumps({"kernels": [{
        "name": "rollout_step", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": err32,
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
