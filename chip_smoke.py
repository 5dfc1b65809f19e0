#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``sympgpr_tpu_torch``).

Builds every hand-written CUDA kernel from the checkout's sources (one nvcc
per source, all at once) and drives two main paths on the card:

* the tokamak workload at the reference configuration (N=80 training
  crossings, 30 test orbits, nm=1000) through the rollout kernel;
* the large-N tokamak workload (``tokamak_large``: N=4096 real crossings,
  60 Adam steps over the closed-form NLL gradient in float32, 30 orbits
  over nm=1000, and the same models rolled out in float64 by the plain
  fast path) through the covariance build and contraction (their
  symmetric, fused modes), triangular matmul, syrk and rollout kernels.

Each kernel is held against its plain PyTorch version at the main path's
shapes, and both are timed with CUDA events around one call (best of 3),
beside the least time the card could take for the same work (bytes over
HBM rate, or operations over the rate of their unit) and, where one
PyTorch call computes the same function, that call's time.  The
covariance kernels (~0.1 ms, where one call's time holds its wrapper's
host work) also print their time over 20 calls back to back (``call_ms``)
and ``torch.profiler``'s device time of their kernels (``kernel_ms``, null
where the profiler records none).  The rollout kernel is also timed at
the four float32 shapes of the main paths (``rollout_shapes``: the bench batch
32768 x 1000 and the reference 30 x 1000 at N=80, ``tokamak_large``'s
30 x 1000 apply and 4096 x 256 batch at N=4096) and held against its plain
version in float64 at N=4096.

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
LIBRARIES = ("rollout_step", "cov_blocks", "tri_matmul")
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
# float32 at N=4096: a 4096-point sum carries float32 rounding above
# ATOL_F32 (kernel vs plain version 8.9e-4 at steps 1-2 on an H100).  So
# both float32 versions are held against the float64 rollout of the same
# float32 columns: the kernel's L2 error at steps 1-2 within 3x the plain
# version's, as the contraction check below (H100: kernel 1.6e-3, plain
# 2.0e-3).  A rollout without one lane's points lies at 22; the phase
# checks that the bound rejects it.
ROLLOUT_NOISE_FACTOR = 3

# Peaks of one H100 SXM at 700 W (NVIDIA's data sheet): the least time a
# kernel could take is the larger of its bytes over the memory rate and its
# operations over the rate of their unit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12    # outside the tensor cores
FP64_FLOP_PER_S = 34e12    # outside the tensor cores
SFU_EXP_PER_S = 132 * 16 * 1.98e9  # 16 transcendentals per clock per SM
# one instruction a clock from each of an SM's 4 schedulers, for 32 lanes:
# the rate at which the card issues thread-instructions (= FP32 lanes)
INSTR_PER_S = FP32_FLOP_PER_S / 2

# FP32 operations (an FMA counts 2) per pair in the rollout kernel's
# formulas; the exps are counted apart, on the SFUs
FLOP_SETUP = 21   # sin/cos of h(u - q), s, s', s'', c0..c3
FLOP_NEWTON = 15  # per Newton iteration
FLOP_Q = 11       # q update
FLOP_AUX = 11     # per aux point
FLOP_ORBIT = 250  # per orbit and step: the Newton updates, the loss solve


def bound(nbytes: float, flops: float, fp64: bool = False,
          exps: float = 0.0, instrs: float = 0.0) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for the work; ``instrs`` are
    thread-instructions, at the card's issue rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / (FP64_FLOP_PER_S if fp64 else FP32_FLOP_PER_S),
                exps / SFU_EXP_PER_S, instrs / INSTR_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rollout_bound(B: int, nm: int, ns: int, nas: int, elt: int,
                  iters: int = 5) -> dict:
    """The rollout's work for B orbits over nm steps: each column read
    once, Q and P written once; per orbit-step (1 + iters) exps per
    training point (A B = exp(-(s + dP^2 / 2 ly^2)) once per Newton
    iteration and once for the q update) and one per aux point."""
    steps = (nm - 1) * B
    exps = steps * ((1 + iters) * ns + nas)
    flops = steps * (ns * (FLOP_SETUP + iters * FLOP_NEWTON + FLOP_Q)
                     + nas * FLOP_AUX + FLOP_ORBIT)
    nbytes = elt * ((4 * ns + 3 * nas) + 2 * B + 2 * nm * B)
    ms, by = bound(nbytes, flops, elt == 8, 0.0 if elt == 8 else exps)
    return dict(bound_ms=ms, bound_by=by, exps=exps, flops=flops,
                bytes=nbytes)


# SASS opcodes of the floating-point pipes (FP32, FP64, conversions, SFU)
FP_OPS = {"FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FSET", "FRND",
          "FCHK", "F2F", "F2I", "I2F", "F2FP", "MUFU", "DADD", "DMUL", "DFMA",
          "DSETP", "DMNMX"}


def sass_counts(path) -> dict:
    """SASS instructions (NOPs left out) of every kernel instance in a
    built library (``cuobjdump -sass``, beside nvcc), keyed by mangled
    name: all of them, and those of the floating-point pipes."""
    import os

    from sympgpr_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out = {}
    for part in dump.split("Function : ")[1:]:
        head, body = part.split("\n", 1)
        ops = [o for o in (_opcode(ln) for ln in body.splitlines()) if o]
        out[head.strip()] = dict(total=sum(o != "NOP" for o in ops),
                                 fp=sum(o in FP_OPS for o in ops))
    return out


def sass_instructions(library: str, kernel: str) -> dict:
    """``sass_counts`` of the kernel instance whose mangled name holds
    ``kernel`` in the library built from ``library``'s source."""
    from sympgpr_tpu_torch.ops import _build

    for name, counts in sass_counts(_build.library_path(library)).items():
        if kernel in name:
            return counts
    raise ValueError(f"no kernel {kernel!r} in {library}")


def _opcode(line: str) -> str | None:
    """The base opcode of one line of ``cuobjdump -sass``, or None."""
    line = line.strip()
    if not line.startswith("/*") or "*/" not in line[2:]:
        return None
    words = line.split("*/", 1)[1].split()
    if words and words[0].startswith("@"):  # predicate
        words = words[1:]
    return words[0].split(".")[0].rstrip(";") if words else None


def cov_bound(N: int, elt: int, fused: bool, fwd: bool,
              instr_per_pair: float) -> dict:
    """The covariance kernels' work at N0 = N: the build writes the whole
    (2N, 2N) matrix; the general contraction reads Kbar whole, the fused
    one the lower triangles of S's xx and yy blocks, its lower-left block
    and alpha; each reads the points.  Pairs: all N^2, or the N (N + 1) / 2
    on and below the diagonal for the fused contraction."""
    pairs = N * (N + 1) // 2 if fused else N * N
    if fwd or not fused:
        nbytes = elt * (4 * N * N + 2 * N)
    else:
        nbytes = elt * (N * (N + 1) + N * N + 2 * N + 2 * N)
    instrs = pairs * instr_per_pair
    ms, by = bound(nbytes, 0.0, instrs=instrs)
    return dict(bound_ms=ms, bound_by=by, bytes=nbytes, pairs=pairs,
                instr_per_pair=instr_per_pair,
                issue_ms=1e3 * instrs / INSTR_PER_S,
                bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S)


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
    from concurrent.futures import ThreadPoolExecutor

    from sympgpr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as ex:  # one nvcc per source
        list(ex.map(_build.build, LIBRARIES))
    for name in LIBRARIES:
        _build.load(name)
    ptxas = {}  # per library: kernel (mangled) -> registers, smem, spills
    for name in LIBRARIES:
        log = _build.library_path(name).with_suffix(".log")
        entries, kernel = {}, None
        for ln in log.read_text().splitlines():
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1]
                entries[kernel] = []
            elif kernel and ("registers" in ln or "spill" in ln):
                entries[kernel].append(ln.split(": ", 1)[-1].strip())
        ptxas[name] = {k: "; ".join(v) for k, v in entries.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)


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


def _time(fn, reps=3, calls=1):
    """Best of ``reps`` after one warm-up, in ms a call (CUDA events around
    ``calls`` calls back to back: more than one lets the wrapper's host
    work overlap the card's for a kernel of ~0.1 ms)."""
    fn()
    sync()
    best = math.inf
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        sync()
        best = min(best, a.elapsed_time(b) / calls)
    return best


def kernel_ms(fn, pattern: str, calls: int = 20) -> float | None:
    """ms a call on the card of the kernels whose name holds ``pattern``:
    ``torch.profiler``'s device time over ``calls`` calls after a warm-up,
    or None where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    us = sum(getattr(e, "device_time_total", 0) or
             getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if pattern in e.key)
    return us / calls / 1e3 if us else None


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


# --- the large-N path (tokamak_large) ----------------------------------------

# the fit settings the BENCH_r05 tokamak_large row ended with (sig2n 1e-2
# after its escalation, 60 steps), at its N; the fitted models also roll
# out in float64 (the plain fast path, no kernel)
LARGE = dict(n_train=4096, nm=1000, steps=60, sig2n=1e-2, aux_subsample=512,
             rollout_batch=4096, with_f64_rollout=True)
# quality gates, loose because float32 sums run in another order than on
# the TPU; the BENCH_r05 row (TPU v5e, quality numbers, not speed) beside
GATES_LARGE = {"gd": 1e-3, "mean_Eosc": 2.5e-2, "n_lost": 1,
               "train_mse": 5e-3}
BENCH_R05_ROW = {"gd": 9.6e-5, "mean_Eosc": 1.12e-2, "n_lost": 0,
                 "train_mse": 8.8e-4}
# kernel vs plain version, float32 at the main path's shapes:
RTOL_BUILD_F32 = 1e-5  # per element, a few ulp of sincos/exp; of max |K|
# contraction: the gradient <Kbar, dK> sums (2N)^2 terms whose magnitudes
# add to ~5e8 at the fitted theta and nearly cancel (components O(1-1e3)),
# so float32 arithmetic in any order leaves an error set by its inputs.
# The kernel is held against the plain version in float64 on the same
# float32 Kbar, within a few times the error of the plain version run in
# float32 (L2 over the components).  On an H100 at N=4096: kernel 0.55 vs
# plain float32 0.78 at the fitted theta, 0.021 vs 0.027 at theta0; an
# all-zero output lies 20 and 742 away, a sum over half of the pairs 18
# and 383, and the phase checks that the bound rejects both.
CONTRACT_NOISE_FACTOR = 3
# syrk: float32 input accumulated in float64, held against the plain
# version in float64 on the same W: one float32 rounding per entry, and
# |S_ij| <= max|S| (Cauchy-Schwarz), so 1e-6 of max|S| (u = 6e-8)
RTOL_SYRK_F32 = 1e-6
# trimm: the same bound against max(|A| |tril(L)|) (no Cauchy-Schwarz)
RTOL_TRIMM_F32 = 1e-4
RTOL_F64 = 1e-12  # float64 instances, same formulas in another order
# the covariance kernels (~0.1 ms) and the passes they replaced are timed
# over this many calls back to back
COV_CALLS = 20
LARGE_SOURCES = {
    "cov_fwd": ("sympgpr_tpu_torch/csrc/cov_blocks.cu",
                "sympgpr_tpu/ops/pallas_cov.py:88"),   # def _cov_tile
    "cov_bwd": ("sympgpr_tpu_torch/csrc/cov_blocks.cu",
                "sympgpr_tpu/ops/pallas_cov.py:187"),  # def _cov_bwd_tile
    "syrk": ("sympgpr_tpu_torch/csrc/tri_matmul.cu",
             "sympgpr_tpu/ops/pallas_syrk.py:33"),     # def _syrk_tile
    "trimm": ("sympgpr_tpu_torch/csrc/tri_matmul.cu",
              "sympgpr_tpu/ops/pallas_trimm.py:40"),   # def _trimm_tile
}


def _large_counts(zero: bool = False) -> dict:
    from sympgpr_tpu_torch.ops import cuda_cov, cuda_step, cuda_syrk, \
        cuda_trimm

    if zero:
        cuda_cov.LAUNCHES_FWD = cuda_cov.LAUNCHES_BWD = 0
        cuda_syrk.LAUNCHES = cuda_trimm.LAUNCHES = cuda_step.LAUNCHES = 0
    return {"cov_fwd": cuda_cov.LAUNCHES_FWD,
            "cov_bwd": cuda_cov.LAUNCHES_BWD, "syrk": cuda_syrk.LAUNCHES,
            "trimm": cuda_trimm.LAUNCHES, "rollout": cuda_step.LAUNCHES}


def phase_large_main(dev):
    from sympgpr_tpu_torch.workloads import tokamak_large

    _large_counts(zero=True)
    t0 = time.perf_counter()
    out = tokamak_large.run(**LARGE, device=dev)
    sync()
    wall = time.perf_counter() - t0
    launches = _large_counts()
    models = out.pop("models")
    sgp = models[0]
    hist = np.asarray(out.pop("hist"))
    fit_ms = 1e3 * (out["fit_s"] - out["fit_escalation_s"]) / LARGE["steps"]
    res = dict(out, wall_s=wall, fit_ms_per_step=fit_ms, launches=launches,
               bench_r05_row=BENCH_R05_ROW, gates=GATES_LARGE,
               hist_first_last=[hist[0], hist[-1]])
    emit("large_main", **res)
    for k, n in launches.items():
        assert n > 0, f"the large-N path launched no {k} kernel"
    assert np.all(np.isfinite(hist)), hist
    assert out["nll_last"] < out["nll_first"], res
    assert out["dtype"] == "float32" and sgp.X.device.type == "cuda"
    for k in ("gd", "mean_Eosc", "train_mse"):
        assert out[k] <= GATES_LARGE[k], (k, out[k])
    assert out["n_lost"] <= GATES_LARGE["n_lost"], out["n_lost"]
    # the same models in float64: the map's own energy oscillation
    assert out["mean_Eosc_f64"] <= GATES_LARGE["mean_Eosc"], out
    assert out["n_lost_f64"] <= GATES_LARGE["n_lost"], out
    return models, launches


# the rollout at the main paths' float32 shapes: (orbits, steps, model)
ROLLOUT_SHAPES = {
    "bench_32768x1000_n80": (BENCH_ORBITS, NM, "n80"),
    "ref_30x1000_n80": (30, NM, "n80"),
    "large_apply_30x1000_n4096": (30, LARGE["nm"], "n4096"),
    "large_batch_4096x256_n4096": (LARGE["rollout_batch"], 256, "n4096"),
}
F64_LARGE_STEPS = 5


def _rollout_noise_check(pm, q0, p0, sm_count) -> dict:
    """The float32 kernel and plain version at steps 1-2 against the
    float64 rollout of the same float32 columns: L2 errors over (Q, P)
    and their max; the plain version without the points of the kernel's
    last lane (n = team - 1 mod team) beside them."""
    import dataclasses

    from sympgpr_tpu_torch.ops import cuda_step as cs

    Qk, Pk = cs.rollout_in_kernel(pm, q0, p0, 3, loss_check=True)
    sync()
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 3, loss_check=True)
    exact = dataclasses.replace(
        pm, **{f: getattr(pm, f).double() for f in (
            "uq", "uP", "a0", "a1", "auxq", "auxp", "auxa", "scal")})
    Qx, Px = cs.rollout_reference(exact, q0.double(), p0.double(), 3,
                                  loss_check=True)
    geo = cs.launch_geometry(q0.shape[0], pm.ns, pm.nas, q0.dtype, sm_count)
    dropped = dataclasses.replace(pm, a0=pm.a0.clone(), a1=pm.a1.clone())
    dropped.a0[geo.team - 1::geo.team] = 0
    dropped.a1[geo.team - 1::geo.team] = 0
    Qd, Pd = cs.rollout_reference(dropped, q0, p0, 3, loss_check=True)

    def err(Q, P) -> float:
        d = torch.cat([Q[1:3].double() - Qx[1:3], P[1:3].double() - Px[1:3]])
        return float(d[~torch.isnan(d)].norm())

    plain = err(Qr, Pr)
    return dict(ns=pm.ns, steps=2, geometry=geo.__dict__, err=err(Qk, Pk),
                plain_err=plain, bound=ROLLOUT_NOISE_FACTOR * plain,
                lane_dropped_err=err(Qd, Pd),
                max_abs_err=max(_max_diff(Qk[1:3], Qr[1:3]),
                                _max_diff(Pk[1:3], Pr[1:3])),
                nan_pattern_equal=bool(torch.equal(torch.isnan(Pk),
                                                   torch.isnan(Pr))))


def phase_rollout_shapes(dev, pm32, large_models):
    """The rollout kernel at the four float32 shapes of the main paths:
    its geometry, time, rate and bound; float32 at N=4096 (lanes of 16
    points) against the float64 rollout at steps 1-2 beside the plain
    version, and float64 at N=4096 against the plain version over a few
    steps."""
    from sympgpr_tpu_torch.ops import cuda_step as cs

    sgp, aux = large_models
    pms = {"n80": pm32, "n4096": cs.pack_models(sgp, aux, mod_q=2 * math.pi)}
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {}
    for name, (batch, nm, model) in ROLLOUT_SHAPES.items():
        pm = pms[model]
        q0, p0 = _ics(dev, torch.float32, -(-batch // 30))
        q0, p0 = q0[:batch].contiguous(), p0[:batch].contiguous()
        ms = _time(lambda: cs.rollout_in_kernel(pm, q0, p0, nm,
                                                loss_check=True))
        b = rollout_bound(batch, nm, pm.ns, pm.nas, 4)
        shapes[name] = dict(
            orbits=batch, nm=nm, ns=pm.ns, nas=pm.nas, ms=ms,
            orbit_steps_per_s=(nm - 1) * batch / (ms * 1e-3),
            geometry=cs.launch_geometry(batch, pm.ns, pm.nas, torch.float32,
                                        sm_count).__dict__,
            bound_ms=b["bound_ms"], bound_by=b["bound_by"],
            bound_share=b["bound_ms"] / ms,
            sfu_ms=1e3 * b["exps"] / SFU_EXP_PER_S,
            fp32_ms=1e3 * b["flops"] / FP32_FLOP_PER_S)

    # float32 at the large-N apply's shape: the kernel's 16-point instance
    q0, p0 = _ics(dev, torch.float32)
    f32 = _rollout_noise_check(pms["n4096"], q0, p0, sm_count)

    pm64 = cs.pack_models(sgp, aux, mod_q=2 * math.pi, dtype=torch.float64)
    q0, p0 = _ics(dev, torch.float64)
    Qk, Pk = cs.rollout_in_kernel(pm64, q0, p0, F64_LARGE_STEPS,
                                  loss_check=True)
    sync()
    Qr, Pr = cs.rollout_reference(pm64, q0, p0, F64_LARGE_STEPS,
                                  loss_check=True)
    f64 = dict(ns=pm64.ns, steps=F64_LARGE_STEPS,
               max_abs_err=max(_max_diff(Qk, Qr), _max_diff(Pk, Pr)),
               nan_pattern_equal=bool(torch.equal(torch.isnan(Pk),
                                                  torch.isnan(Pr))),
               lost=int(torch.isnan(Pk[-1]).sum()),
               ms=_time(lambda: cs.rollout_in_kernel(
                   pm64, q0, p0, F64_LARGE_STEPS, loss_check=True)))
    emit("rollout_shapes", shapes=shapes, f32_n4096=f32, f64_n4096=f64)
    assert f32["nan_pattern_equal"] and f32["err"] <= f32["bound"], f32
    # the bound would fail a kernel that left out one lane's points
    assert f32["lane_dropped_err"] > f32["bound"], f32
    assert f64["nan_pattern_equal"] and f64["max_abs_err"] <= ATOL_F64, f64
    assert f64["lost"] < 30, f64


def _rel_to_max(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def _contraction_check(X, params, sig, Kbar64, Kbar_plain, got) -> dict:
    """L2 errors of a contraction ``got`` against the plain version in
    float64 on Kbar64, beside the errors of the plain version on
    ``Kbar_plain`` (the float32 Kbar, as the fit used to store it), of an
    all-zero output, of a sum over the pairs of only the first half of the
    points and of a sum over the pair tiles on and below the diagonal
    without counting the off-diagonal ones twice."""
    from sympgpr_tpu_torch.ops import cuda_cov

    def plain(X, params, sig, Kbar):
        dp, ds = cuda_cov.cov_param_grads_reference("per_se", X, X, params,
                                                    sig, Kbar)
        return torch.cat([dp.double(), ds.double()[None]])

    X64, p64, s64 = (t.double() for t in (X, params, sig))
    ref = plain(X64, p64, s64, Kbar64)
    N = X.shape[0]
    half = Kbar64.clone()
    half[N // 2:N] = 0
    half[N + N // 2:] = 0
    half_err = float((plain(X64, p64, s64, half) - ref).norm())
    del half
    tile = torch.arange(N, device=X.device) // cuda_cov.TILE
    lower = (tile[:, None] >= tile[None, :]).double().repeat(2, 2)
    no_x2_err = float((plain(X64, p64, s64, Kbar64 * lower) - ref).norm())
    del lower
    got = torch.cat([got[0].double(), got[1].double()[None]])

    def err(v):
        return float((v - ref).norm())

    return dict(ref=ref.tolist(), got=got.tolist(), err=err(got),
                max_abs_err=float((got - ref).abs().max()),
                plain_err=err(plain(X, params, sig, Kbar_plain)),
                zero_err=err(torch.zeros_like(ref)),
                half_pairs_err=half_err, lower_no_x2_err=no_x2_err,
                ref_norm=float(ref.norm()))


def _trimm_check(side, A, B, sign) -> tuple[float, float]:
    """Max abs error of the trimm kernel against its plain version on the
    same operands, and that error over max(|A| |B|), the triangular
    operand taken lower."""
    from sympgpr_tpu_torch.ops import cuda_trimm

    if side == "right":
        C = cuda_trimm.matmul_tril_right(A, B, sign=sign)
        Cp = cuda_trimm.matmul_tril_right_reference(A, B)
        absA, absB = A.abs(), B.abs().tril()
    else:
        C = cuda_trimm.matmul_tril_left(A, B, sign=sign)
        Cp = cuda_trimm.matmul_tril_left_reference(A, B)
        absA, absB = A.abs().tril(), B.abs()
    e = float((C - sign * Cp).abs().max())
    return e, e / float(torch.matmul(absA, absB).max())


def phase_large_kernels_vs_plain(dev, sgp):
    """The four kernels of the fit step against their plain versions at
    the main path's shapes (N=4096 float32: K and Kbar 8192 x 8192), and
    each float64 instance at a small size."""
    from sympgpr_tpu_torch.gp.likelihood import nll_value_and_grad_theta
    from sympgpr_tpu_torch.kernels import PER_SE
    from sympgpr_tpu_torch.linalg import triangular
    from sympgpr_tpu_torch.ops import cuda_cov, cuda_syrk, cuda_trimm

    X, z, params, sig, s2n = sgp.X, sgp.z, sgp.params, sgp.sig, sgp.sig2n
    n = 2 * X.shape[0]
    res, kernels = {}, {}

    N, elt = X.shape[0], X.element_size()
    # the main path's build: Ky with sig2n on its diagonal, in one launch
    Ky = cuda_cov.build_Ky("per_se", X, params, sig, s2n)
    Kyp = cuda_cov.build_Ky_reference("per_se", X, params, sig, s2n)
    res["build_rel_err"] = _rel_to_max(Ky, Kyp)
    # issue work: the floating-point instructions of the float32 per_se
    # instances' SASS over the 16 pairs a thread takes (the pair loop is
    # unrolled).  Addressing, loads, stores and branches issue on top, and
    # the count holds the block's set-up, once: a lower count of the issue
    # work per pair.  All instructions beside it (untaken paths included).
    sass = {k: sass_instructions("cov_blocks", pattern) for k, pattern in (
        ("fwd", "cov_fwd_kernelIfLi0EE"),
        ("bwd_sym", "cov_bwd_kernelIfLi0ELb1E"),
        ("bwd_general", "cov_bwd_kernelIfLi0ELb0E"))}
    ipp = {k: v["fp"] / 16 for k, v in sass.items()}
    res["sass_instructions"] = sass
    fwd_b = cov_bound(N, elt, False, True, ipp["fwd"])

    def build():
        return cuda_cov.build_Ky("per_se", X, params, sig, s2n)

    kernels["cov_fwd"] = dict(
        max_abs_err=float((Ky - Kyp).abs().max()),
        **{k: fwd_b[k] for k in ("bound_ms", "bound_by")},
        library_ms=None, ms=_time(build),
        call_ms=_time(build, calls=COV_CALLS),
        kernel_ms=kernel_ms(build, "cov_fwd"),
        plain_ms=_time(lambda: cuda_cov.build_Ky_reference(
            "per_se", X, params, sig, s2n)),
        replaced_plain_passes_ms={"eye_add": _time(
            lambda: Ky + s2n * torch.eye(n, dtype=Ky.dtype, device=dev),
            calls=COV_CALLS)})
    res["build_bound"] = fwd_b
    del Kyp
    # the general entry (BuildK's), on the same points
    res["build_general_rel_err"] = _rel_to_max(
        cuda_cov.build_K_blocks("per_se", X, X, params, sig),
        cuda_cov.build_K_blocks_reference("per_se", X, X, params, sig))

    # the run's fit-step intermediates at the trained hyperparameters
    L, info = torch.linalg.cholesky_ex(Ky)
    assert int(info) == 0, "Cholesky failed at the trained hyperparameters"
    alpha = torch.cholesky_solve(z[:, None], L)[:, 0]
    where_ms = _time(lambda: torch.where(info == 0, L, math.nan),
                     calls=COV_CALLS)

    # every trimm product of one tri_inv_blocked, recorded: the strided
    # views of W and L it passes, and its sign
    calls = []
    right, left = cuda_trimm.matmul_tril_right, cuda_trimm.matmul_tril_left
    cuda_trimm.matmul_tril_right = lambda A, B, out=None, sign=1: \
        calls.append(("right", A, B, sign)) or right(A, B, out, sign)
    cuda_trimm.matmul_tril_left = lambda A, B, out=None, sign=1: \
        calls.append(("left", A, B, sign)) or left(A, B, out, sign)
    try:
        W = triangular.tri_inv_blocked(L).contiguous()
    finally:
        cuda_trimm.matmul_tril_right, cuda_trimm.matmul_tril_left = \
            right, left
    trimm_err, trimm_rel, trimm_ms, trimm_plain_ms, levels = 0.0, 0.0, 0, 0, []
    trimm_lib_ms, trimm_flops, trimm_bytes = 0.0, 0.0, 0.0
    for side, A, B, sign in calls:
        e, rel = _trimm_check(side, A, B, sign)
        trimm_err, trimm_rel = max(trimm_err, e), max(trimm_rel, rel)
        fn = right if side == "right" else left
        ref_fn = (cuda_trimm.matmul_tril_right_reference if side == "right"
                  else cuda_trimm.matmul_tril_left_reference)
        ms = _time(lambda: fn(A, B, sign=sign))
        pms = _time(lambda: ref_fn(A, B))
        lms = _time(lambda: torch.matmul(A, B))  # dense, one cuBLAS call
        trimm_ms += ms
        trimm_plain_ms += pms
        trimm_lib_ms += lms
        nb, s, _ = A.shape
        trimm_flops += nb * s * s * (s + 1)  # triangular MACs x 2
        trimm_bytes += 3 * nb * s * s * A.element_size()
        levels.append(dict(
            side=side, shape=list(A.shape), ms=ms, plain_ms=pms,
            library_ms=lms,
            tflops=nb * s * s * (s + 1) / (ms * 1e9),  # triangular MACs x 2
            plain_tflops=2 * nb * s ** 3 / (pms * 1e9)))  # dense flops
    res["trimm_levels"] = levels
    res["trimm_rel_err"] = trimm_rel
    kernels["trimm"] = dict(max_abs_err=trimm_err, ms=trimm_ms,
                            plain_ms=trimm_plain_ms, library_ms=trimm_lib_ms,
                            **dict(zip(("bound_ms", "bound_by"),
                                       bound(trimm_bytes, trimm_flops))))
    # a ragged float32 case: s = 300 is no multiple of the 128-wide tile
    g = torch.Generator().manual_seed(1)
    A300 = torch.randn(3, 300, 300, generator=g).to(dev)
    L300 = torch.randn(3, 300, 300, generator=g).tril().to(dev)
    L300 += torch.triu(torch.full_like(L300, math.nan), 1)  # never read
    res["trimm_ragged_300_rel_err"] = {
        side: _trimm_check(side, A300, L300, 1)[1] if side == "right"
        else _trimm_check(side, L300, A300, 1)[1]
        for side in ("right", "left")}

    S = cuda_syrk.syrk_lower(W)
    W64 = W.double()  # for the float64 reference and DGEMM, not timed
    S64 = cuda_syrk.syrk_lower_reference(W64)
    res["syrk_rel_err"] = _rel_to_max(S, S64)
    res["syrk_plain_f32_rel_err"] = _rel_to_max(
        cuda_syrk.syrk_lower_reference(W), S64)
    m = W.shape[0]
    kernels["syrk"] = dict(
        max_abs_err=float((S.double() - S64).abs().max()),
        ms=_time(lambda: cuda_syrk.syrk_lower(W)),
        plain_ms=_time(lambda: cuda_syrk.syrk_lower_reference(W)),
        # the same function, float64 products and sums: cuBLAS DGEMM on
        # the float64 copy of W
        library_ms=_time(lambda: torch.matmul(W64.T, W64)),
        # cuBLAS float32 W.T @ W accumulates in float32: another function
        library_f32_accumulation_ms=_time(lambda: torch.matmul(W.T, W)),
        # the lower triangle of W^T W over a triangular W: m^3 / 6 MACs.
        # The kernel runs on the float64 tensor cores (DMMA), whose
        # 67 TFLOP/s peak the FP32 rate used here equals; the float64 SIMT
        # pipe's 34 TFLOP/s would not bound it.
        **dict(zip(("bound_ms", "bound_by"),
                   bound(2 * W.numel() * W.element_size(), m ** 3 / 3))))
    res["syrk_tflops"] = m ** 3 / 3 / (kernels["syrk"]["ms"] * 1e9)
    del S64, W64

    # the main path's contraction: the fused entry on (S, alpha); the
    # general entry on the float32 Kbar beside it
    Kbar = 0.5 * S - 0.5 * torch.outer(alpha, alpha)
    S64, a64 = S.double(), alpha.double()
    Kbar64 = 0.5 * S64 - 0.5 * torch.outer(a64, a64)
    del S64
    got = cuda_cov.cov_param_grads_sym("per_se", X, params, sig, S, alpha)
    contraction = _contraction_check(X, params, sig, Kbar64, Kbar, got)
    contraction["bound"] = CONTRACT_NOISE_FACTOR * contraction["plain_err"]
    general = cuda_cov.cov_param_grads("per_se", X, X, params, sig, Kbar)
    general = torch.cat([general[0].double(), general[1].double()[None]])
    contraction["general_err"] = float(
        (general - torch.tensor(contraction["ref"], device=dev)).norm())
    del Kbar64
    res["contraction"] = contraction
    bwd_b = cov_bound(N, elt, True, False, ipp["bwd_sym"])

    def contract():
        return cuda_cov.cov_param_grads_sym("per_se", X, params, sig, S,
                                            alpha)

    kernels["cov_bwd"] = dict(
        max_abs_err=contraction["max_abs_err"],
        **{k: bwd_b[k] for k in ("bound_ms", "bound_by")},
        library_ms=None, ms=_time(contract),
        call_ms=_time(contract, calls=COV_CALLS),
        kernel_ms=kernel_ms(contract, "cov_"),
        plain_ms=_time(lambda: cuda_cov.cov_param_grads_sym_reference(
            "per_se", X, params, sig, S, alpha)),
        replaced_plain_passes_ms={
            "where_L": where_ms,
            "kbar": _time(lambda: 0.5 * S - 0.5 * torch.outer(alpha, alpha),
                          calls=COV_CALLS)})
    res["contraction_bound"] = bwd_b
    def contract_general():
        return cuda_cov.cov_param_grads("per_se", X, X, params, sig, Kbar)

    res["contraction_general"] = dict(
        ms=_time(contract_general),
        kernel_ms=kernel_ms(contract_general, "cov_"),
        **cov_bound(N, elt, False, False, ipp["bwd_general"]))

    # the fit step and its sub-layers, float32 at N=4096
    theta = torch.log10(torch.cat([params, sig[None]]))
    res["step_ms"] = dict(
        fit_step=_time(lambda: nll_value_and_grad_theta(PER_SE, theta, s2n,
                                                        X, z)),
        build=kernels["cov_fwd"]["ms"],
        cholesky=_time(lambda: torch.linalg.cholesky_ex(Ky)),
        alpha_solve=_time(lambda: torch.cholesky_solve(z[:, None], L)),
        tri_inv=_time(lambda: triangular.tri_inv_blocked(L)),
        syrk=kernels["syrk"]["ms"], contraction=kernels["cov_bwd"]["ms"])
    del Ky, L, W, S, Kbar

    # the float64 instances at a small size
    f64 = {}
    g = torch.Generator().manual_seed(0)
    X64 = torch.stack([torch.rand(256, generator=g, dtype=torch.float64)
                       * 6.28, torch.rand(256, generator=g,
                                          dtype=torch.float64) * 4 - 2],
                      1).to(dev)
    p64 = torch.tensor([0.9, 1.7], dtype=torch.float64, device=dev)
    s64 = torch.tensor(2.5, dtype=torch.float64, device=dev)
    f64["build"] = _rel_to_max(
        cuda_cov.build_K_blocks("per_se", X64, X64, p64, s64),
        cuda_cov.build_K_blocks_reference("per_se", X64, X64, p64, s64))
    f64["build_sym"] = _rel_to_max(
        cuda_cov.build_Ky("per_se", X64, p64, s64, 0.3),
        cuda_cov.build_Ky_reference("per_se", X64, p64, s64, 0.3))
    Kb64 = torch.randn(512, 512, generator=g, dtype=torch.float64).to(dev)
    got64 = cuda_cov.cov_param_grads("per_se", X64, X64, p64, s64, Kb64)
    c64 = _contraction_check(X64, p64, s64, Kb64, Kb64, got64)
    f64["contraction"] = c64["err"] / c64["ref_norm"]
    S64 = Kb64 + Kb64.T
    al64 = torch.randn(512, generator=g, dtype=torch.float64).to(dev)
    got64 = cuda_cov.cov_param_grads_sym("per_se", X64, p64, s64, S64, al64)
    c64 = _contraction_check(X64, p64, s64,
                             0.5 * S64 - 0.5 * torch.outer(al64, al64),
                             Kb64, got64)
    f64["contraction_sym"] = c64["err"] / c64["ref_norm"]
    A64 = torch.randn(2, 256, 256, generator=g, dtype=torch.float64).to(dev)
    L64 = torch.randn(2, 256, 256, generator=g,
                      dtype=torch.float64).tril().to(dev)
    f64["trimm_right"] = _rel_to_max(
        cuda_trimm.matmul_tril_right(A64, L64),
        cuda_trimm.matmul_tril_right_reference(A64, L64))
    f64["trimm_left"] = _rel_to_max(
        cuda_trimm.matmul_tril_left(L64, A64),
        cuda_trimm.matmul_tril_left_reference(L64, A64))
    W64 = L64[0, :250, :250].contiguous()
    f64["syrk"] = _rel_to_max(cuda_syrk.syrk_lower(W64),
                              cuda_syrk.syrk_lower_reference(W64))
    res["f64_rel_err"] = f64
    res["kernels"] = kernels
    emit("large_kernels_vs_plain", **res)
    assert res["build_rel_err"] <= RTOL_BUILD_F32, res
    assert res["build_general_rel_err"] <= RTOL_BUILD_F32, res
    assert contraction["err"] <= contraction["bound"], contraction
    assert contraction["general_err"] <= contraction["bound"], contraction
    # the bound would fail a kernel that returns zeros, sums half the pairs
    # or sums the lower tiles without counting the off-diagonal ones twice
    assert min(contraction["zero_err"], contraction["half_pairs_err"],
               contraction["lower_no_x2_err"]) > contraction["bound"], \
        contraction
    assert res["syrk_rel_err"] <= RTOL_SYRK_F32, res
    assert trimm_rel <= RTOL_TRIMM_F32, res
    assert max(res["trimm_ragged_300_rel_err"].values()) <= RTOL_TRIMM_F32, \
        res["trimm_ragged_300_rel_err"]
    assert len(levels) == 2 * 4, levels  # levels s = 512 ... 4096
    assert max(f64.values()) <= RTOL_F64, f64
    return kernels


def phase_escalation(dev):
    """The singular-K jitter escalation through the kernels (threshold
    forced to 1 so the 48-point case takes the kernel build)."""
    from sympgpr_tpu_torch.ops import cuda_cov
    from sympgpr_tpu_torch.workloads.tokamak_large import fit_sympgp_large

    rng = np.random.default_rng(0)
    n = 48
    base = np.stack([rng.uniform(0, 2 * np.pi, n // 2),
                     rng.uniform(0.5, 6.0, n // 2)], 1)
    X = torch.tensor(np.concatenate([base, base]), dtype=torch.float32,
                     device=dev)  # duplicated points: K singular
    z = torch.tensor(rng.normal(size=2 * n) * 0.1, dtype=torch.float32,
                     device=dev)
    threshold, cuda_cov.NLL_THRESHOLD = cuda_cov.NLL_THRESHOLD, 1
    before = cuda_cov.LAUNCHES_BWD
    try:
        _, hist, mse, tim = fit_sympgp_large(
            X, z, sig2n=1e-12, theta0=(0.5, 2.5, 2.0), steps=5, lr=5e-2)
    finally:
        cuda_cov.NLL_THRESHOLD = threshold
    res = dict(tim, nll_last=float(hist[-1]), train_mse=mse,
               contraction_launches=cuda_cov.LAUNCHES_BWD - before)
    emit("escalation", **res)
    assert res["contraction_launches"] > 0
    assert tim["jitter_escalations"] >= 1 and tim["sig2n_used"] > 1e-12
    assert np.isfinite(hist[-1]) and np.isfinite(mse)


def main() -> None:
    dev, smi = phase_device()
    # the plain versions are the yardstick: full float32 matrix products
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on"
    phase_build()
    out, launches = phase_main_kernel(dev)
    phase_main_generic(dev)
    pm32, err32, ms, plain_ms = phase_kernel_vs_plain(dev, out["models"])
    phase_throughput(dev, pm32)
    large_models, large_launches = phase_large_main(dev)
    large = phase_large_kernels_vs_plain(dev, large_models[0])
    phase_rollout_shapes(dev, pm32, large_models)
    del large_models
    phase_escalation(dev)
    b = rollout_bound(30, NM, pm32.ns, pm32.nas, 4)
    rows = [{"name": "rollout_step", "route": "cuda", "source": KERNEL_SOURCE,
             "replaces": REPLACES, "launches": launches,
             "max_abs_err": err32, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "library_ms": None}]
    for name, (source, replaces) in LARGE_SOURCES.items():
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": large_launches[name], **large[name]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
