#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``sympgpr_tpu_torch``).

Builds every hand-written CUDA kernel from the checkout's sources (one nvcc
per source, all at once) and drives the main paths on the card:

* the tokamak workload at the reference configuration (N=80 training
  crossings, 30 test orbits, nm=1000) through the rollout kernel;
* the Split tokamak (``tokamak_split``: N=70 crossings for each of 4
  sub-maps of a quarter turn, nph=100, CMA-ES fits, 30 orbits over 4000
  sub-map steps) through the rollout kernel's sub-map cycling and its loss
  check at the new q; the same fitted models also roll out in float64 on
  the plain fast path (``apply_map_split``);
* the large-N tokamak workload (``tokamak_large``: N=4096 real crossings,
  60 Adam steps over the closed-form NLL gradient in float32, 30 orbits
  over nm=1000, and the same models rolled out in float64 by the plain
  fast path) through the covariance build and contraction (their
  symmetric, fused modes), triangular matmul, syrk, alpha product and
  rollout kernels;
* the standard map (``standard_map``, ``standard_map_explicit``: k=2,
  N=20, 30 orbits over nm=100) through the rollout kernel's mod_p / pdiff
  mode and Algorithm 2, and in float64 on the plain fast path; the three
  pendulum workloads at their reference configurations (nm=1000), kernel
  and float64; ``standard_map_large`` (N=4096 exact pairs, 60 Adam steps,
  30 orbits over 200 rows) through kernels 2-5, the alpha product and the
  mod_p / pdiff mode.
  ``modes_kernel_vs_plain`` holds the explicit update, Algorithm 2 and
  mod_p / pdiff against the plain version on these models, shows that its
  gates fail two wrong trajectories, and times each mode at 32768 x 1000
  (N=20) and at 30 x 200 (N=4096);
* ``split_modes_kernel_vs_plain``: the rollout kernel's Split instances
  of the explicit update, Algorithm 2 and mod_p / pdiff
  (``csrc/rollout_split_modes.cu``), each on two or four sub-maps (the
  standard map's fits beside fits at k = 1.5, standard_map_large's model
  beside its 2 pi-shifted twin, the Split tokamak's four sub-maps with
  pdiff and the loss at the new q) and on one map checked at the new q,
  driven through ``rollout_model`` and held against the plain version
  (float64 one step from each of 200 rows, float32 within 3x the plain
  version's error), two wrong kernels that the gates must fail (sub-map 0
  on every step, pdiff after the new q's NaN), timed at 32768 x 1000
  (N=20) beside the one-map instances;
* ``bench_main``: ``python -m sympgpr_tpu_torch bench --device cuda`` (the
  headline benchmark: the N=80 fit, the CPU baseline, 30 x 10,000 and
  32768 x 1000 through the rollout kernel, the large-N stages cut to
  N=1024, NUTS) in a process of its own, its headline last;
* the perturbed pendulum and Henon-Heiles (``pert_henon_main``:
  ``pert_pendulum`` and ``henon_heiles`` at RESULTS.md's configurations,
  30 x 100 and 37 x 500, through the rollout kernel's periodic instance
  with an aux model of the absolute P and its SE x SE instance without a
  wrap of q, and in float64 on the plain fast path);
  ``pert_henon_kernel_vs_plain`` holds the kernel against its plain
  version on both fitted models, times both rollouts, and runs the
  generic autodiff map path on the card against the fast path;
* the samplers, Adam and Sobol in float64, which launch no kernel of the
  repo (N = 18-80 is under the covariance kernels' threshold):
  ``posterior_parity`` (the pendulum N = 18 hyperposterior: a 40^3
  quadrature through ``nll_batched``, NUTS 4 x 250 and adaptive HMC
  4 x 600 held to the four gates of tests/test_posterior_parity.py, one
  transition of each on the card against CPU tensors and its host
  syncs), ``sample_main`` (the CLI's ``sample``: NUTS on ``tokamak``, HMC
  on ``pendulum_implicit``, 8 chains, 25 + 25 transitions),
  ``sobol_main`` (the CLI's ``sobol``: 512 QoI rows x 960 steps) and
  ``adam_main`` (``fit_batch_adam`` over the Split tokamak's four sets
  against ``minimize_adam``; ``tokamak_kernel`` with Adam, one rollout);
* ``large_n_main``: ``workloads/large_n.py`` (the CLI's ``bench
  --large-n``): ``measure(N=4096)`` times the build, the Cholesky, the NLL,
  the closed-form and autodiff steps, 10 Adam steps, the triangular
  inverse, the syrk and a 4096 x 256 deployment rollout, each stage's
  kernels counted, beside the least time for its work; its float32
  gradients against float64; ``rollout_sweep`` over N = 512 ... 8192 at
  4096 x 256, each instance's kernel against its plain version; one
  ``bench --large-n`` process;
* ``distributed_main`` (slice F): ``run large_n --distributed`` at N=4096,
  20 Adam steps on one NCCL rank in float32 (its alpha against a dense
  float64 solve, its gradient at theta0 against float64, one
  factorization and one value and gradient timed); two ranks sharing the
  card under gloo (this script with ``--dist-rank R DIR``): the float64
  value, gradient and alpha at N=1024 against one rank, the bench batch
  32768 x 1000 through ``rollout_in_kernel_sharded`` (each rank's kernel
  columns held to the one-process kernel run and to the plain version),
  ``sample_nuts_sharded`` (4 chains x 20 transitions) equal to its
  per-shard runs.

Each kernel is held against its plain PyTorch version at the main paths'
shapes, and both are timed with CUDA events around one call (best of 3),
beside the least time the card could take for the same work (bytes over
HBM rate, or operations over the rate of their unit) and, where one
PyTorch call computes the same function, that call's time.  The
covariance kernels (~0.1 ms, where one call's time holds its wrapper's
host work) also print their time over 20 calls back to back (``call_ms``)
and ``torch.profiler``'s device time of their kernels (``kernel_ms``, null
where the profiler records none).  The rollout kernel is also timed at
the four float32 shapes of the single-map paths (``rollout_shapes``: the bench batch
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

from sympgpr_tpu_torch import profiling
from sympgpr_tpu_torch.ops import rollout_check as rc

# the rollout kernel's template; rollout_step.cu and rollout_split_modes.cu
# instantiate it
KERNEL_SOURCE = "sympgpr_tpu_torch/csrc/rollout_kernel.cuh"
REPLACES = "sympgpr_tpu/ops/pallas_step.py:259"  # def _rollout_kernel
LIBRARIES = ("rollout_step", "rollout_split_modes", "cov_blocks",
             "tri_matmul")
BENCH_ORBITS = 32768  # the orbit-batched size of the JAX package's bench
NM = 1000

# gates of the main path (tests/test_workloads.py test_tokamak_single and
# test_tokamak_pallas_backend at the reference size)
GATE_TRAIN_ERR = 1e-12
GATE_MEDIAN_GD = 2e-2
GATE_LOST = 10
# RESULTS.md row "05 tokamak (N=80, nm=1000)", float64 on the CPU
RESULTS_ROW = {"train_err": 1.9e-20, "Eosc": 8.2e-3, "gd": 2.5e-4, "lost": 0}
# the Split tokamak: tests/test_workloads.py test_tokamak_split (training
# error) and test_tokamak_split_pallas_backend (median gd) at the reference
# size; RESULTS.md row "05 tokamak split (nphmap=4, nm=4000)", float64 on
# the CPU, for the float64 rollout of the same models
NM_SPLIT = 4000
GATE_TRAIN_ERR_SPLIT = 1e-10
RESULTS_ROW_SPLIT = {"train_err": 3.5e-21, "Eosc": 9.3e-3, "gd": 3.0e-5,
                     "lost": 0}

# kernel vs plain version on the card
ATOL_F64 = 1e-9  # every step of 100, float64: ~1e-15 per step on regular orbits
# float32 at steps 1-2: each float32 version is within 3e-5 of the float64
# rollout at step 2 (plain version on the CPU at this size), so two
# float32 versions agree within 2 x 3e-5; 1e-4 leaves margin
ATOL_F32 = 1e-4
EOSC_RTOL_F32 = 0.1  # mean Eosc over 1000 steps, float32 (decoherent orbits)
LOST_SLACK_F32 = 1

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
# the explicit update's P sum per pair (dP, dP^2, the exponent, c0 + c1 dP,
# times A B, the add), and Algorithm 2's per point: sin/cos of h(u - q),
# s, s', s'' and a0 (s'' - s'^2) A; its q update a1 h B
FLOP_EXPLICIT_P = 9
FLOP_SUM_SETUP = 12
FLOP_SUM_P = 3
FLOP_SUM_Q = 8
# per orbit and step without Newton: sin/cos of h(q), the wraps, pdiff
FLOP_ORBIT_EXPLICIT = 40


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
                  iters: int = 5, n_maps: int = 1, mode: str = "implicit",
                  pdiff: bool = False) -> dict:
    """The rollout's work for B orbits over nm steps: each column (of each
    of ``n_maps`` sub-maps) read once, Q and P (and with ``pdiff`` D)
    written once; per orbit-step, with one sub-map of ``ns`` training and
    ``nas`` aux points: the implicit map (1 + iters) exps per training
    point (A B = exp(-(s + dP^2 / 2 ly^2)) once per Newton iteration and
    once for the q update) and one per aux point; the explicit update
    (``mode="explicit"``) two per training point (its P sum and the q
    update) and none for aux points; Algorithm 2 (``"sum"``) two (A for P,
    B for the q update)."""
    steps = (nm - 1) * B
    if mode == "implicit":
        exps = steps * ((1 + iters) * ns + nas)
        flops = steps * (ns * (FLOP_SETUP + iters * FLOP_NEWTON + FLOP_Q)
                         + nas * FLOP_AUX + FLOP_ORBIT)
    elif mode == "explicit":
        exps = steps * 2 * ns
        flops = steps * (ns * (FLOP_SETUP + FLOP_EXPLICIT_P + FLOP_Q)
                         + FLOP_ORBIT_EXPLICIT)
    else:
        exps = steps * 2 * ns
        flops = steps * (ns * (FLOP_SUM_SETUP + FLOP_SUM_P + FLOP_SUM_Q)
                         + FLOP_ORBIT_EXPLICIT)
    nbytes = elt * (n_maps * (4 * ns + 3 * nas) + 2 * B
                    + (3 if pdiff else 2) * nm * B)
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


T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line for a phase; ``t_s`` is the seconds since the script
    started, so the lines give each phase's share of the wall time."""
    print(json.dumps({"phase": phase, **kw,
                      "t_s": time.perf_counter() - T0}, default=float),
          flush=True)


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

    def timed_build(name: str) -> float:
        t = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as ex:  # one nvcc per source
        nvcc_s = dict(zip(LIBRARIES, ex.map(timed_build, LIBRARIES)))
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
    emit("build", seconds=time.perf_counter() - t0, nvcc_s=nvcc_s,
         instances={k: len(v) for k, v in ptxas.items()}, ptxas=ptxas)


def phase_main_kernel(dev):
    from sympgpr_tpu_torch.systems import tokamak as tk
    from sympgpr_tpu_torch.workloads import tokamak as wl

    cfg = tk.TokamakConfig()
    profiling.launch_counts(zero=True)
    out = wl.run(cfg, nm=NM, backend="kernel", with_reference=False,
                 device=dev)
    launches = profiling.launch_counts()["rollout"]
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


def _ics(dev, dtype, reps=1, cfg=None):
    from sympgpr_tpu_torch.systems import tokamak as tk

    (r0, th0), _ = tk.test_initial_conditions(cfg or tk.TokamakConfig())
    pth0, q0 = tk.ics_to_pth(np.tile(r0, reps), np.tile(th0, reps), dev)
    return q0.to(dtype).contiguous(), (pth0 * 1e2).to(dtype).contiguous()


def _eosc_lost(Q, P):
    from sympgpr_tpu_torch.eval import metrics
    from sympgpr_tpu_torch.systems import tokamak as tk

    H = tk.field_energy(tk.TokamakConfig().field, Q, P)
    return (float(np.nanmean(metrics.energy_oscillation(H).cpu().numpy())),
            int(torch.isnan(P[-1]).sum()))


def _time(fn, reps=3, calls=1, warmup=True):
    """Best of ``reps`` after one warm-up, in ms a call: the package's one
    timer, ``profiling.best_ms`` (CUDA events around ``calls`` calls back
    to back: more than one lets the wrapper's host work overlap the card's
    for a kernel of ~0.1 ms).  ``warmup=False`` where the caller has just
    run ``fn``."""
    return profiling.best_ms(fn, reps, calls, warmup, device="cuda")


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

    (sgp,), (aux,) = models
    sd, ad = sgp.for_deployment(1e-3), aux.for_deployment(1e-3)

    pm64 = cs.pack_models(sd, ad, mod_q=2 * math.pi, dtype=torch.float64)
    q0, p0 = _ics(dev, torch.float64)
    Qk, Pk = cs.rollout_in_kernel(pm64, q0, p0, 100, loss_check=True)
    sync()
    Qr, Pr = cs.rollout_reference(pm64, q0, p0, 100, loss_check=True)
    err64 = max(rc.max_abs_diff(Qk, Qr), rc.max_abs_diff(Pk, Pr))
    nan_same64 = bool(torch.equal(torch.isnan(Pk), torch.isnan(Pr)))

    pm32 = cs.pack_models(sd, ad, mod_q=2 * math.pi)
    q0, p0 = _ics(dev, torch.float32)
    Qk, Pk = cs.rollout_in_kernel(pm32, q0, p0, NM, loss_check=True)
    sync()
    Qr, Pr = cs.rollout_reference(pm32, q0, p0, NM, loss_check=True)
    err32 = max(rc.max_abs_diff(Qk[1:3], Qr[1:3]),
                rc.max_abs_diff(Pk[1:3], Pr[1:3]))
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


# --- the Split tokamak (tokamak_split) ---------------------------------------


def _split_cfg():
    from sympgpr_tpu_torch.__main__ import SPLIT
    from sympgpr_tpu_torch.systems import tokamak as tk

    return tk.TokamakConfig(**SPLIT, nm=NM_SPLIT)


def phase_split_main(dev):
    """tokamak_split through the kernel backend: four CMA-ES fitted
    sub-maps, 30 orbits over 4000 sub-map steps in float32, the sub-maps
    cycled inside the kernel, the loss checked at the new q.  The NLL
    evaluations of the fits are counted (the symplectic GPs' and the aux
    GPs')."""
    from sympgpr_tpu_torch.gp import likelihood
    from sympgpr_tpu_torch.systems import tokamak as tk
    from sympgpr_tpu_torch.workloads import tokamak as wl

    cfg = _split_cfg()
    evals = {"nll": 0, "nll_reg": 0}
    nlls = {k: getattr(likelihood, k) for k in evals}

    def counted(name):
        def fn(*a, **k):
            evals[name] += 1
            return nlls[name](*a, **k)
        return fn

    for k in evals:
        setattr(likelihood, k, counted(k))
    profiling.launch_counts(zero=True)
    t0 = time.perf_counter()
    try:
        out = wl.run(cfg, optimizer="cmaes", backend="kernel",
                     with_reference=False, device=dev)
        sync()
    finally:
        for k, fn in nlls.items():
            setattr(likelihood, k, fn)
    wall = time.perf_counter() - t0
    counts = profiling.launch_counts()
    launches, launches_split = counts["rollout"], counts["rollout_split"]
    (r0, th0), _ = tk.test_initial_conditions(cfg)
    t0 = time.perf_counter()
    out.update(wl.one_turn_gd(cfg, out["traj"], r0, th0, dev))
    t_gd = time.perf_counter() - t0
    res = dict(training_error=out["training_error"],
               mean_gd=float(np.nanmean(out["gd"])),
               median_gd=float(np.nanmedian(out["gd"])),
               mean_Eosc=float(np.nanmean(out["Eosc"])),
               n_lost=out["n_lost"], t_train=out["t_train"],
               nfev_sympl=out["nfev_sympl"], nll_evaluations=evals,
               ms_per_nll_evaluation=1e3 * out["t_train"]
               / sum(evals.values()), t_apply=out["t_apply"],
               wall_s=wall, t_one_turn_reference=t_gd, launches=launches,
               launches_split=launches_split,
               hyps=[h.tolist() for h in out["hyps"]], sigs=out["sigs"],
               dtype=str(out["traj"].q.dtype),
               shape=list(out["traj"].q.shape))
    emit("split_main", **res)
    assert launches >= 1, "the Split path launched no rollout kernel"
    assert launches_split > 0, "the Split path launched no Split instance"
    assert res["training_error"] < GATE_TRAIN_ERR_SPLIT, res
    assert res["median_gd"] < GATE_MEDIAN_GD, res
    assert res["n_lost"] <= GATE_LOST, res
    assert res["shape"] == [NM_SPLIT, cfg.Ntest], res
    assert out["traj"].q.device.type == "cuda"
    return out, launches


def phase_split_generic(dev, models):
    """The same fitted sub-maps rolled out in float64 by apply_map_split
    (the fast path, masked early-exit Newton) on the card, held to the
    RESULTS.md row within 2x."""
    from sympgpr_tpu_torch.systems import tokamak as tk
    from sympgpr_tpu_torch.workloads import tokamak as wl

    cfg = _split_cfg()
    sgps, auxes = models
    (r0, th0), _ = tk.test_initial_conditions(cfg)
    pth0, Q0 = tk.ics_to_pth(r0, th0, dev)
    t0 = time.perf_counter()
    traj = wl.rollout(cfg, sgps, auxes, Q0, pth0 * cfg.momentum_scale,
                      NM_SPLIT, "generic")
    sync()
    t_apply = time.perf_counter() - t0
    gd = wl.one_turn_gd(cfg, traj, r0, th0, dev)["gd"]
    res = dict(mean_gd=float(np.nanmean(gd)),
               mean_Eosc=float(np.nanmean(wl.section_eosc(cfg, traj))),
               n_lost=int(torch.isnan(traj.p[-1]).sum()), t_apply=t_apply,
               dtype=str(traj.q.dtype), results_row=RESULTS_ROW_SPLIT)
    emit("split_generic", **res)
    assert traj.q.dtype == torch.float64 and traj.q.device.type == "cuda"
    assert res["n_lost"] == RESULTS_ROW_SPLIT["lost"], res
    for k, ref in (("mean_gd", RESULTS_ROW_SPLIT["gd"]),
                   ("mean_Eosc", RESULTS_ROW_SPLIT["Eosc"])):
        assert 0.5 <= res[k] / ref <= 2.0, (k, res[k], ref)


def _first_lost(P) -> torch.Tensor:
    """The row at which each orbit turns NaN (the row count if never)."""
    nan = torch.isnan(P)
    return torch.where(nan.any(0), nan.int().argmax(0), P.shape[0])


def phase_split_kernel_vs_plain(dev, models):
    """The kernel against rollout_reference on the Split packed models:
    float64 over 100 steps, float32 at steps 1-2 and the statistics over
    the 4000 steps, as kernel_vs_plain; then two wrong kernels the gates
    must fail: sub-map 0 on every step, and the loss checked at the old q
    on ICs near the loss boundary, where the two checks lose orbits at
    other steps."""
    from sympgpr_tpu_torch.ops import cuda_step as cs
    from sympgpr_tpu_torch.systems import tokamak as tk

    cfg = _split_cfg()
    sgps, auxes = models
    sd = [s.for_deployment(1e-3) for s in sgps]
    ad = [a.for_deployment(1e-3) for a in auxes]
    kw = dict(loss_check=True, loss_at_new_q=True)

    pm64 = cs.pack_models_split(sd, ad, mod_q=2 * math.pi,
                                dtype=torch.float64)
    q0, p0 = _ics(dev, torch.float64, cfg=cfg)
    Qk, Pk = cs.rollout_in_kernel(pm64, q0, p0, 100, **kw)
    sync()
    Qr, Pr = cs.rollout_reference(pm64, q0, p0, 100, **kw)
    err64 = max(rc.max_abs_diff(Qk, Qr), rc.max_abs_diff(Pk, Pr))
    nan_same64 = bool(torch.equal(torch.isnan(Pk), torch.isnan(Pr)))
    # wrong kernel 1: sub-map 0 on every step
    first = cs.pack_models_split([sd[0]] * 4, [ad[0]] * 4,
                                 mod_q=2 * math.pi, dtype=torch.float64)
    Qw, Pw = cs.rollout_in_kernel(first, q0, p0, 100, **kw)
    sync()
    submap0_err64 = max(rc.max_abs_diff(Qw, Qr), rc.max_abs_diff(Pw, Pr))

    pm32 = cs.pack_models_split(sd, ad, mod_q=2 * math.pi)
    q0, p0 = _ics(dev, torch.float32, cfg=cfg)
    Qk, Pk = cs.rollout_in_kernel(pm32, q0, p0, NM_SPLIT, **kw)
    sync()
    plain = {}  # the plain version's one run, timed (18-20 s)

    def plain_run():
        plain["traj"] = cs.rollout_reference(pm32, q0, p0, NM_SPLIT, **kw)

    plain_ms = _time(plain_run, reps=1, warmup=False)
    Qr, Pr = plain["traj"]
    err32 = max(rc.max_abs_diff(Qk[1:3], Qr[1:3]),
                rc.max_abs_diff(Pk[1:3], Pr[1:3]))
    # the energy on the sections (every 4th row), the lost orbits at the end
    eosc_k = _eosc_lost(Qk[::4], Pk[::4])[0]
    eosc_r = _eosc_lost(Qr[::4], Pr[::4])[0]
    lost_k, lost_r = (int(torch.isnan(P[-1]).sum()) for P in (Pk, Pr))
    Qw, Pw = cs.rollout_in_kernel(
        cs.pack_models_split([sd[0]] * 4, [ad[0]] * 4, mod_q=2 * math.pi),
        q0, p0, 3, **kw)
    sync()
    submap0_err32 = max(rc.max_abs_diff(Qw[1:3], Qr[1:3]),
                        rc.max_abs_diff(Pw[1:3], Pr[1:3]))
    ms = _time(lambda: cs.rollout_in_kernel(pm32, q0, p0, NM_SPLIT, **kw))
    b = rollout_bound(30, NM_SPLIT, pm32.ns, pm32.nas, 4, n_maps=4)

    # wrong kernel 2: the loss at the old q, on ICs near r = 0.5 spread
    # over the angle (float64, 100 steps)
    r0 = np.repeat(np.linspace(0.44, 0.5, 8), 8)
    th0 = np.tile(np.linspace(0.0, 2 * math.pi, 8, endpoint=False), 8)
    pth, qb = tk.ics_to_pth(r0, th0, dev)
    pb = (pth * cfg.momentum_scale).contiguous()
    Qn, Pn = cs.rollout_in_kernel(pm64, qb, pb, 100, **kw)
    Qo, Po = cs.rollout_in_kernel(pm64, qb, pb, 100, loss_check=True)
    sync()
    Qbr, Pbr = cs.rollout_reference(pm64, qb, pb, 100, **kw)
    lost_new, lost_old = _first_lost(Pn), _first_lost(Po)
    boundary = dict(
        err=max(rc.max_abs_diff(Qn, Qbr), rc.max_abs_diff(Pn, Pbr)),
        nan_pattern_equal=bool(torch.equal(torch.isnan(Pn),
                                           torch.isnan(Pbr))),
        lost_new_q=int((lost_new < 100).sum()),
        lost_old_q=int((lost_old < 100).sum()),
        orbits_lost_at_other_steps=int((lost_new != lost_old).sum()),
        old_q_err=max(rc.max_abs_diff(Qo, Qbr), rc.max_abs_diff(Po, Pbr)),
        old_q_nan_pattern_equal=bool(torch.equal(torch.isnan(Po),
                                                 torch.isnan(Pbr))))
    res = dict(f64_max_abs_err_100_steps=err64, f64_atol=ATOL_F64,
               f64_nan_pattern_equal=nan_same64,
               f32_max_abs_err_steps_1_2=err32, f32_atol=ATOL_F32,
               f32_mean_Eosc_kernel=eosc_k, f32_mean_Eosc_plain=eosc_r,
               f32_lost_kernel=lost_k, f32_lost_plain=lost_r,
               submap0_f64_err=submap0_err64, submap0_f32_err=submap0_err32,
               boundary=boundary, ns=pm32.ns, nas=pm32.nas,
               ms_30x4000_f32=ms, plain_ms_30x4000_f32=plain_ms,
               geometry=cs.launch_geometry(30, pm32.ns, pm32.nas,
                                           torch.float32,
                                           n_maps=4).__dict__,
               bound_ms=b["bound_ms"], bound_by=b["bound_by"],
               bound_share=b["bound_ms"] / ms)
    emit("split_kernel_vs_plain", **res)
    assert nan_same64 and err64 <= ATOL_F64, res
    assert err32 <= ATOL_F32, res
    assert abs(eosc_k - eosc_r) <= EOSC_RTOL_F32 * eosc_r, res
    assert abs(lost_k - lost_r) <= LOST_SLACK_F32, res
    assert boundary["nan_pattern_equal"] and boundary["err"] <= ATOL_F64, res
    # the gates fail both wrong kernels
    assert submap0_err64 > ATOL_F64 and submap0_err32 > ATOL_F32, res
    assert boundary["orbits_lost_at_other_steps"] > 0, res
    assert not boundary["old_q_nan_pattern_equal"], res
    return err32, ms, plain_ms


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
# the alpha product: float32 input summed in float64 and rounded once, as
# its plain version, so the two differ by at most one float32 rounding
RTOL_MATVEC_F32 = 1e-6
# the Cholesky written over Ky: float64 sums as its plain version, each
# rounding its stored blocks to float32 once an update, so on a
# well-conditioned SPD matrix (eigenvalues in [1, 5]) the two lie a few
# float32 roundings of the factor's largest entry apart
RTOL_POTRF_F32 = 1e-6
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
    # no TPU counterpart: the JAX package solves for alpha
    "matvec": ("sympgpr_tpu_torch/csrc/tri_matmul.cu", None),
    # no TPU counterpart: the JAX package factors with jnp.linalg.cholesky
    "potrf": ("sympgpr_tpu_torch/csrc/tri_matmul.cu", None),
}


def phase_large_main(dev):
    from sympgpr_tpu_torch.workloads import tokamak_large

    profiling.launch_counts(zero=True)
    t0 = time.perf_counter()
    out = tokamak_large.run(**LARGE, device=dev)
    sync()
    wall = time.perf_counter() - t0
    launches = profiling.launch_counts()
    models = out.pop("models")
    sgp = models[0]
    hist = np.asarray(out.pop("hist"))
    fit_ms = 1e3 * (out["fit_s"] - out["fit_escalation_s"]) / LARGE["steps"]
    res = dict(out, wall_s=wall, fit_ms_per_step=fit_ms, launches=launches,
               bench_r05_row=BENCH_R05_ROW, gates=GATES_LARGE,
               hist_first_last=[hist[0], hist[-1]])
    emit("large_main", **res)
    for k in profiling.KERNELS:
        assert launches[k] > 0, f"the large-N path launched no {k} kernel"
    assert launches["rollout_cluster"] > 0, \
        "the N=4096 rollout ran no cluster team"
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
    last lane (n = width - 1 mod width, the width of a cluster team's
    lanes over its blocks) beside them."""
    import dataclasses

    from sympgpr_tpu_torch.ops import cuda_step as cs

    Qk, Pk = cs.rollout_in_kernel(pm, q0, p0, 3, loss_check=True)
    sync()
    Qr, Pr = cs.rollout_reference(pm, q0, p0, 3, loss_check=True)
    exact = rc.as_float64(pm)
    Qx, Px = cs.rollout_reference(exact, q0.double(), p0.double(), 3,
                                  loss_check=True)
    geo = cs.launch_geometry(q0.shape[0], pm.ns, pm.nas, q0.dtype, sm_count)
    width = geo.team * geo.cluster
    dropped = dataclasses.replace(pm, a0=pm.a0.clone(), a1=pm.a1.clone())
    dropped.a0[width - 1::width] = 0
    dropped.a1[width - 1::width] = 0
    Qd, Pd = cs.rollout_reference(dropped, q0, p0, 3, loss_check=True)

    def err(Q, P) -> float:
        d = torch.cat([Q[1:3].double() - Qx[1:3], P[1:3].double() - Px[1:3]])
        return float(d[~torch.isnan(d)].norm())

    plain = err(Qr, Pr)
    return dict(ns=pm.ns, steps=2, geometry=geo.__dict__, err=err(Qk, Pk),
                plain_err=plain, bound=rc.NOISE_FACTOR * plain,
                lane_dropped_err=err(Qd, Pd),
                max_abs_err=max(rc.max_abs_diff(Qk[1:3], Qr[1:3]),
                                rc.max_abs_diff(Pk[1:3], Pr[1:3])),
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
               max_abs_err=max(rc.max_abs_diff(Qk, Qr),
                               rc.max_abs_diff(Pk, Pr)),
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


# workloads/large_n.py at the JAX package's bench size (K 8192 x 8192 in
# float32), and its rollout sweep up to the kernel's widest float32 team
LARGE_N = 4096
LARGE_N_SIG2N = 1e-2
SWEEP_NS = (512, 1024, 2048, 4096, 8192)
SWEEP_B, SWEEP_NM = 4096, 256


def phase_large_n_main(dev) -> dict:
    """``workloads/large_n.py`` on the card: ``measure(N=4096)`` (each
    stage's ms beside the least time for its work) and ``rollout_sweep``
    over N = 512 ... 8192 at 4096 x 256, with the kernels' counts around
    both; then, outside the counts, the float32 gradients against float64,
    the kernel against its plain version on 32 orbits x 2 steps of
    ``measure``'s deployment rollout (rebuilt from its trained theta) and
    of each sweep instance, and one ``bench --large-n`` process."""
    from sympgpr_tpu_torch.ops import cuda_step as cs
    from sympgpr_tpu_torch.workloads import large_n

    t0 = time.perf_counter()
    profiling.launch_counts(zero=True)
    m = large_n.measure(N=LARGE_N, sig2n=LARGE_N_SIG2N, device=dev)
    sweep = large_n.rollout_sweep(Ns=SWEEP_NS, B=SWEEP_B, nm=SWEEP_NM,
                                  device=dev)
    sync()
    launches = profiling.launch_counts()
    t_main = time.perf_counter() - t0

    n, elt = 2 * LARGE_N, 4
    roll = rollout_bound(large_n.ROLLOUT_B, large_n.ROLLOUT_NM, LARGE_N, 8,
                         elt)
    bounds = {  # (key of measure, (least ms, set by))
        "build": ("build_s", bound(n * n * elt, 0.0)),
        "cholesky": ("cholesky_s", bound(2 * n * n * elt, n**3 / 3)),
        "triinv": ("triinv_s", bound(2 * n * n * elt, n**3 / 3)),
        "syrk": ("syrk_s", bound(2 * n * n * elt, n**3 / 3)),
        "rollout": ("rollout_run_s", (roll["bound_ms"], roll["bound_by"])),
    }
    stages = {name: dict(ms=1e3 * m[key], bound_ms=b[0], bound_by=b[1],
                         bound_share=b[0] / (1e3 * m[key]))
              for name, (key, b) in bounds.items()}
    for name, key in (("nll_eval", "nll_eval_s"),
                      ("train_step", "train_step_s"),
                      ("train_step_autodiff", "train_step_autodiff_s"),
                      ("adam_10step", "adam_10step_s")):
        stages[name] = dict(ms=1e3 * m[key])

    grads = large_n.check_gradients(LARGE_N, LARGE_N_SIG2N, device=dev)
    X, z = large_n.synthetic_training_set(LARGE_N, device=dev)
    deployment = large_n.sweep_check(*large_n.deployment_instance(
        torch.tensor(m["rollout_theta"], device=dev), X, z,
        torch.tensor(LARGE_N_SIG2N, device=dev)), orbits=32, steps=2)
    del X, z
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    checks = {}
    for N, pm, q0, p0 in large_n.sweep_instances(SWEEP_NS, SWEEP_B, dev):
        b = rollout_bound(SWEEP_B, SWEEP_NM, pm.ns, pm.nas, elt)
        checks[N] = dict(
            large_n.sweep_check(pm, q0, p0, orbits=32, steps=2),
            ms=sweep[f"N{N}_ms"], bound_ms=b["bound_ms"],
            bound_by=b["bound_by"], bound_share=b["bound_ms"]
            / sweep[f"N{N}_ms"],
            geometry=cs.launch_geometry(SWEEP_B, pm.ns, pm.nas,
                                        torch.float32, sm_count).__dict__)
    sync()
    t1 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "sympgpr_tpu_torch", "bench", "--large-n",
         "--n", str(LARGE_N), "--device", "cuda"],
        capture_output=True, text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    bench = json.loads(lines[-1]) if r.returncode == 0 and lines else None
    res = dict(measure=m, sweep=sweep, stages=stages, launches=launches,
               gradients=grads, deployment_check=deployment,
               sweep_checks=checks,
               bench=dict(rc=r.returncode, s=time.perf_counter() - t1,
                          metric=bench and bench["metric"],
                          value=bench and bench["value"],
                          unit=bench and bench["unit"],
                          stderr_tail=r.stderr[-2000:]),
               main_s=t_main, wall_s=time.perf_counter() - t0)
    emit("large_n_main", **res)
    for k in profiling.KERNELS:
        assert launches[k] > 0, f"large_n launched no {k} kernel"
    assert set(m["launches"]) == set(large_n.STAGE_KERNELS), m["launches"]
    for stage, kernels in large_n.STAGE_KERNELS.items():
        got = {k for k, c in m["launches"][stage].items() if c > 0}
        assert got == kernels, (stage, m["launches"][stage])
    assert m["dtype"] == "float32" and m["N"] == LARGE_N, m
    assert m["nll_decreased"], m
    # every deployment orbit stays finite over 256 steps (H100: 1.0)
    assert m["rollout_finite_frac"] == 1.0, m
    assert deployment["ok"], deployment
    assert grads["ok"], grads
    for N, c in checks.items():
        assert c["ok"], (N, c)
    assert r.returncode == 0, r.stderr[-2000:]
    assert bench["metric"] == "large_n_build_plus_cholesky_gflops", bench
    assert math.isfinite(bench["value"]) and bench["value"] > 0, bench
    return launches


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
    """The six kernels of the fit step against their plain versions at
    the main path's shapes (N=4096 float32: K and Kbar 8192 x 8192), and
    each float64 instance at a small size."""
    from sympgpr_tpu_torch.gp.likelihood import nll_value_and_grad_theta
    from sympgpr_tpu_torch.kernels import PER_SE
    from sympgpr_tpu_torch.linalg import potrf, triangular
    from sympgpr_tpu_torch.ops import cuda_cov, cuda_matvec, cuda_syrk, \
        cuda_trimm

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

    # the fit step's factor written over a copy of Ky, against its plain
    # version (the same blocks) and cholesky_ex: each factor's backward
    # error ||L L^T - Ky|| / ||Ky||, and the largest gaps between the
    # factors (on the fit's Ky, conditioned by sig2n = 1e-2, two float32
    # factors lie ~1e-6 (kernel, plain) and ~2e-3 (cholesky_ex) apart, so
    # the elementwise bound is held on a well-conditioned SPD matrix)
    buf = Ky.clone()
    Lk, info_k = potrf.cholesky_in_place(buf)
    Lk = torch.tril(Lk)
    Lp, info_p = potrf.potrf_lower_reference(Ky.clone())
    Lp = torch.tril(Lp)
    assert int(info_k) == info_p == 0, (int(info_k), info_p)
    res["potrf_fit_Ky_rel_err"] = _rel_to_max(Lk, Lp)
    potrf_abs = float((Lk - Lp).abs().max())
    res["potrf_vs_cholesky_ex_rel_err"] = _rel_to_max(Lk, L)
    Ky64 = Ky.double()
    res["potrf_backward_err"] = {
        k: float((F.double() @ F.double().T - Ky64).norm() / Ky64.norm())
        for k, F in (("kernel", Lk), ("plain", Lp), ("cholesky_ex", L))}
    del Ky64, Lp, Lk
    gw = torch.Generator(device=dev).manual_seed(0)
    B = torch.randn(n, n, generator=gw, dtype=torch.float64, device=dev)
    Kw = (B @ B.T / n + torch.eye(n, dtype=torch.float64, device=dev)).to(
        Ky.dtype)
    del B
    res["potrf_rel_err"] = _rel_to_max(
        torch.tril(potrf.cholesky_in_place(Kw.clone())[0]),
        torch.tril(potrf.potrf_lower_reference(Kw.clone())[0]))
    del Kw

    def factor():
        buf.copy_(Ky)
        return potrf.cholesky_in_place(buf)

    kernels["potrf"] = dict(
        max_abs_err=potrf_abs,
        # one call holds the copy of Ky into the buffer (268 MB); the
        # profiler's device time of the factor's kernels does not
        ms=_time(factor), kernel_ms=kernel_ms(factor, "potrf_", 5),
        plain_ms=_time(lambda: potrf.potrf_lower_reference(Ky.clone())),
        library_ms=_time(lambda: torch.linalg.cholesky_ex(Ky)),
        # n^3 / 3 on the float64 tensor cores at 67 TFLOP/s
        **dict(zip(("bound_ms", "bound_by"),
                   bound(2 * n * n * elt, n ** 3 / 3))))
    del buf
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

    # the step's alpha = S z by the product kernel, against its plain
    # version, and each float32 alpha against a float64 solve with L
    am = cuda_matvec.matvec(S, z)
    am_plain = cuda_matvec.matvec_reference(S, z)
    res["matvec_rel_err"] = _rel_to_max(am, am_plain)
    a64 = torch.cholesky_solve(z.double()[:, None], L.double())[:, 0]
    res["alpha_rel_l2_vs_f64_solve"] = {
        k: float((a.double() - a64).norm() / a64.norm())
        for k, a in (("matvec", am), ("cholesky_solve", alpha))}
    kernels["matvec"] = dict(
        max_abs_err=float((am.double() - am_plain.double()).abs().max()),
        ms=_time(lambda: cuda_matvec.matvec(S, z)),
        plain_ms=_time(lambda: cuda_matvec.matvec_reference(S, z)),
        # the call it replaces in the step, computing the same alpha
        library_ms=_time(lambda: torch.cholesky_solve(z[:, None], L)),
        # cuBLAS's float32 gemv sums in float32: another function
        library_f32_accumulation_ms=_time(lambda: torch.mv(S, z)),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(S.numel() * S.element_size(), 2 * m * m))))
    del am, am_plain, a64

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
        factor_in_place=kernels["potrf"]["ms"],
        alpha_solve=kernels["matvec"]["library_ms"],
        alpha_matvec=kernels["matvec"]["ms"],
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
    f64["matvec"] = _rel_to_max(cuda_matvec.matvec(A64[0], A64[1, 0]),
                                cuda_matvec.matvec_reference(A64[0],
                                                             A64[1, 0]))
    K64 = A64[0] @ A64[0].T / 256 + torch.eye(256, dtype=torch.float64,
                                              device=dev)
    K64 = K64[:250, :250].contiguous()
    f64["potrf"] = _rel_to_max(
        torch.tril(potrf.cholesky_in_place(K64.clone())[0]),
        torch.tril(potrf.potrf_lower_reference(K64.clone())[0]))
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
    assert res["matvec_rel_err"] <= RTOL_MATVEC_F32, res
    assert res["potrf_rel_err"] <= RTOL_POTRF_F32, res
    assert res["potrf_backward_err"]["kernel"] <= 2 * res[
        "potrf_backward_err"]["plain"], res["potrf_backward_err"]
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
    before = profiling.launch_counts()["cov_bwd"]
    try:
        _, hist, mse, tim = fit_sympgp_large(
            X, z, sig2n=1e-12, theta0=(0.5, 2.5, 2.0), steps=5, lr=5e-2)
    finally:
        cuda_cov.NLL_THRESHOLD = threshold
    res = dict(tim, nll_last=float(hist[-1]), train_mse=mse,
               contraction_launches=profiling.launch_counts()["cov_bwd"]
               - before)
    emit("escalation", **res)
    assert res["contraction_launches"] > 0
    assert tim["jitter_escalations"] >= 1 and tim["sig2n_used"] > 1e-12
    assert np.isfinite(hist[-1]) and np.isfinite(mse)


# --- the standard map and the pendulum ---------------------------------------

# gates: training error and the kernel backend's one-step MSE
# (tests/test_workloads.py test_standard_map_*, the Pallas ones); the
# float64 one-step MSE of RESULTS.md:13-14 (CPU, float64), held within 2x
GATE_TRAIN_ERR_STDMAP = 1e-10
GATES_STDMAP_KERNEL = {"implicit": 1e-4, "explicit": 1e-5}
RESULTS_STDMAP = {"implicit": 5.7e-8, "explicit": 4.6e-13}
# the pendulum workloads at RESULTS.md:9-11's configurations: float64 mean
# Eosc within 2x of the row; float32 kernel backend under the Pallas gates
# of tests/test_workloads.py; period_ratio within 0.15 of an integer in
# [0.5, 4.5]
PENDULUM = {  # workload: config fields, RESULTS.md Eosc, float32 Eosc gate
    "implicit": ({}, 6.4e-6, 2e-3),
    "explicit": ({"Nm": 70, "sig2_n": 1e-10}, 0.04, 0.2),
    "period_unknown": ({"N": 50, "Nm": 100, "sig2_n": 1e-10}, 2.9e-5,
                       2e-2),
}
RESULTS_EOSC_SE = 1.1e-3  # RESULTS.md:9, the symplectic-Euler comparator
# standard_map_large at the JAX CLI's configuration; VERDICT.md:80 gives
# its one-step MSE from a TPU run (quality only, not a time)
STDMAP_LARGE = dict(n_train=4096, nm=200, steps=60, sig2n=1e-2,
                    aux_subsample=512)
GATE_STDMAP_LARGE_MSE = 1e-4
VERDICT_STDMAP_LARGE_MSE_TPU = 2.3e-6
ATOL_F64_STEP = 1e-12  # float64, one step from each of 100 plain rows
TWO_PI_F32 = float(np.float32(2 * math.pi))  # 2 pi rounded up in float32
MODES_BATCH = 32768    # orbits and steps of the large-batch timing
MODES_STEPS = 1000
# float32 kernel against the plain version at steps 1-2 on the standard
# map's models (|alpha| ~ 9e3 at jitter 1e-5): two float32 summation
# orders lie 1.6e-4 to 5.8e-4 apart there on an H100, above ATOL_F32
ATOL_F32_STDMAP = 1e-3
# float32 statistics over the whole run: mean Eosc (pendulum)
STATS_RTOL_F32 = 0.1


def phase_stdmap_main(dev):
    """standard_map and standard_map_explicit (k = 2, N = 20, 30 orbits,
    nm = 100) through the kernel backend (float32, mod_p and pdiff in the
    kernel; the explicit method's Algorithm 2) and the float64 generic
    backend."""
    from sympgpr_tpu_torch.systems.standard_map import StandardMapConfig
    from sympgpr_tpu_torch.workloads import standard_map as wl

    cfg = StandardMapConfig()
    res, models = {}, {}
    profiling.launch_counts(zero=True)
    for method in ("implicit", "explicit"):
        out = wl.run(cfg, method=method, backend="kernel", device=dev)
        t = out["traj"]
        P = t.p[1:].cpu().numpy()
        res[method] = dict(
            training_error=out["training_error"],
            one_step_mse=out["one_step_mse"],
            gate=GATES_STDMAP_KERNEL[method], t_train=out["t_train"],
            t_apply=out["t_apply"], hyp=out["hyp"].tolist(),
            P_min=float(np.nanmin(P)), P_max=float(np.nanmax(P)),
            D_finite=bool(torch.isfinite(t.pdiff).all()),
            dtype=str(t.q.dtype), shape=list(t.q.shape))
        models[method] = out["models"]
    launches = profiling.launch_counts()["rollout"]
    for method in ("implicit", "explicit"):
        out = wl.run(cfg, method=method, backend="generic", device=dev)
        res[method].update(
            f64_one_step_mse=out["one_step_mse"],
            f64_training_error=out["training_error"],
            f64_t_apply=out["t_apply"],
            results_row=RESULTS_STDMAP[method],
            f64_dtype=str(out["traj"].q.dtype))
    emit("stdmap_main", launches=launches, **res)
    assert launches == 2, "the standard map launched no rollout kernel"
    for method, r in res.items():
        assert r["training_error"] < GATE_TRAIN_ERR_STDMAP, (method, r)
        assert r["one_step_mse"] < r["gate"], (method, r)
        # wrapped into [0, 2 pi): float32 rounds the top of it to fl(2 pi)
        assert 0.0 <= r["P_min"] and r["P_max"] <= TWO_PI_F32, (method, r)
        assert r["D_finite"] and r["dtype"] == "torch.float32", (method, r)
        assert r["f64_dtype"] == "torch.float64", (method, r)
        ratio = r["f64_one_step_mse"] / r["results_row"]
        assert 0.5 <= ratio <= 2.0, (method, r)
    return models, launches


def phase_pendulum_main(dev):
    """The three pendulum workloads at RESULTS.md:9-11's configurations
    (nm = 1000): the kernel backend (float32; the explicit workload's sum
    kernel through Algorithm 2) and the float64 generic backend (the
    implicit workload with its one-map-time reference and the
    symplectic-Euler comparator)."""
    import importlib

    from sympgpr_tpu_torch.systems.pendulum import PendulumConfig

    res, models = {}, {}
    profiling.launch_counts(zero=True)
    for name, (fields, _, _) in PENDULUM.items():
        wl = importlib.import_module(
            f"sympgpr_tpu_torch.workloads.pendulum_{name}")
        kw = (dict(with_reference=False, with_comparator=False)
              if name == "implicit" else {})
        out = wl.run(PendulumConfig(**fields), backend="kernel", **kw,
                     device=dev)
        res[name] = dict(training_error=out["training_error"],
                         mean_Eosc=float(np.nanmean(out["Eosc"])),
                         t_train=out["t_train"], t_apply=out["t_apply"],
                         hyp=out["hyp"].tolist(),
                         dtype=str(out["traj"].q.dtype),
                         shape=list(out["traj"].q.shape))
        if "period_ratio" in out:
            res[name]["period_ratio"] = out["period_ratio"]
        models[name] = out["models"]
    launches = profiling.launch_counts()["rollout"]
    for name, (fields, _, _) in PENDULUM.items():
        wl = importlib.import_module(
            f"sympgpr_tpu_torch.workloads.pendulum_{name}")
        out = wl.run(PendulumConfig(**fields), backend="generic",
                     device=dev)
        r = res[name]
        r.update(f64_mean_Eosc=float(np.nanmean(out["Eosc"])),
                 f64_t_apply=out["t_apply"],
                 f64_dtype=str(out["traj"].q.dtype))
        for k in ("gd", "Eosc_se"):
            if k in out:
                r[f"f64_mean_{k}"] = float(np.nanmean(out[k]))
        if "t_apply_se" in out:
            r["f64_t_apply_se"] = out["t_apply_se"]
        if "period_ratio" in out:
            r["f64_period_ratio"] = out["period_ratio"]
    emit("pendulum_main", launches=launches, results_rows={
        k: v[1] for k, v in PENDULUM.items()}, **res)
    assert launches == 3, "the pendulum launched no rollout kernel"
    for name, (_, eosc_row, gate32) in PENDULUM.items():
        r = res[name]
        assert r["dtype"] == "torch.float32", (name, r)
        assert r["f64_dtype"] == "torch.float64", (name, r)
        assert r["mean_Eosc"] < gate32, (name, r)
        assert 0.5 <= r["f64_mean_Eosc"] / eosc_row <= 2.0, (name, r)
        for k in ("period_ratio", "f64_period_ratio"):
            if k in r:
                ratio = r[k]
                assert abs(ratio - round(ratio)) < 0.15, (name, r)
                assert 0.5 <= ratio <= 4.5, (name, r)
    assert 0.5 <= res["implicit"]["f64_mean_Eosc_se"] / RESULTS_EOSC_SE \
        <= 2.0, res["implicit"]
    return models, launches


def phase_stdmap_large(dev):
    """standard_map_large (N = 4096 exact pairs, 60 Adam steps in float32
    through kernels 2-5, 30 orbits over 200 rows through the rollout
    kernel's mod_p / pdiff mode)."""
    from sympgpr_tpu_torch.workloads import standard_map as wl

    profiling.launch_counts(zero=True)
    t0 = time.perf_counter()
    out = wl.run_large(**STDMAP_LARGE, device=dev)
    sync()
    wall = time.perf_counter() - t0
    launches = profiling.launch_counts()
    models = out.pop("models")
    fit_ms = (1e3 * (out["fit_s"] - out["fit_escalation_s"])
              / STDMAP_LARGE["steps"])
    res = dict(out, wall_s=wall, fit_ms_per_step=fit_ms, launches=launches,
               gate_one_step_mse=GATE_STDMAP_LARGE_MSE,
               verdict_one_step_mse_tpu_run=VERDICT_STDMAP_LARGE_MSE_TPU)
    emit("stdmap_large", **res)
    for k in profiling.KERNELS:
        assert launches[k] > 0, f"standard_map_large launched no {k} kernel"
    assert out["nll_decreased"], res
    assert out["finite_frac"] == 1.0 and out["pdiff_finite"], res
    assert out["one_step_mse"] < GATE_STDMAP_LARGE_MSE, res
    assert out["dtype"] == "float32" and models[0].X.device.type == "cuda"
    return models, launches


def _one_step_along(pm, traj, kw):
    """The kernel's one step (8 Newton iterations) from each of the plain
    trajectory's rows 0 .. nm - 2 (one launch over all of them as orbits,
    one for each sub-map of a Split model) against the plain trajectory's
    next rows: the largest difference in Q, P and, with pdiff, the step's
    unwrapped increment (``rc.step_err``)."""
    from sympgpr_tpu_torch.ops import cuda_step as cs

    return rc.step_err(lambda *a, **k: cs.rollout_in_kernel(*a, iters=8, **k),
                       pm, traj, kw)


def _large_mode_check(dev, sgp, aux, ics) -> dict:
    """standard_map_large's rollout (mod_p / pdiff, N=4096: the float32
    instance with 16 points a lane) against its plain version on the
    workload's models and ICs over its 200 rows: float32 by
    ``rollout_check.f32_vs_f64``, the kernel's errors within 3x the plain
    version's; float64 one step from each of the plain version's 200 rows
    within ATOL_F64, as ``rollout_shapes`` holds tokamak_large's float64
    at N=4096."""
    from sympgpr_tpu_torch.ops import cuda_step as cs

    two_pi = 2 * math.pi
    kw = dict(track_pdiff=True)
    nm = STDMAP_LARGE["nm"]
    out = {}
    for dtype in (torch.float32, torch.float64):
        pm = cs.pack_models(sgp, aux, mod_q=two_pi, mod_p=two_pi,
                            dtype=dtype)
        q, p = (t.to(dtype) for t in ics)
        got = cs.rollout_in_kernel(pm, q, p, nm, iters=8, **kw)
        sync()
        ref = cs.rollout_reference(pm, q, p, nm, iters=8, **kw)
        if dtype == torch.float32:
            out["f32"] = rc.f32_vs_f64(pm, q, p, kw, got, ref)
            out["f32"].pop("err")
        else:
            out["f64"] = dict(
                step_err_200_rows=_one_step_along(pm, ref, kw),
                nan_pattern_equal=all(
                    torch.equal(torch.isnan(g), torch.isnan(t))
                    for g, t in zip(got, ref)))
    out["ns"] = pm.ns
    return out


def _ulp_sensitivity(pm, q0, p0, nm, kw) -> list:
    """How far the plain float64 rollout moves when p0 moves by one ulp:
    its largest difference at steps 1, 10, 50 and nm - 1."""
    from sympgpr_tpu_torch.ops import cuda_step as cs

    a = cs.rollout_reference(pm, q0, p0, nm, 8, **kw)
    b = cs.rollout_reference(pm, q0, torch.nextafter(p0, p0 + 1), nm, 8,
                             **kw)
    return [max(rc.max_abs_diff(x[i], y[i]) for x, y in zip(a, b))
            for i in (1, 10, 50, nm - 1)]


def _sum_q_with_A(pm, q, P):
    """A wrong Algorithm 2 on purpose: its q update with the q-side factor
    A left in (dq = sum a1 h A B), at the plain version's P."""
    from sympgpr_tpu_torch.kernels import PER_SE
    from sympgpr_tpu_torch.ops import cuda_step as cs

    sgp, _ = cs._models_of(pm)
    A, _, _ = PER_SE.q_factors(sgp.X[None, :, 0] - q[:, None], sgp.params)
    ily2 = 1.0 / sgp.params[1] ** 2
    dP = sgp.X[None, :, 1] - P[:, None]
    a1 = pm.a1[: pm.ns]
    Q = q + torch.sum(a1 * (ily2 - dP**2 * ily2**2)
                      * torch.exp(-dP**2 * ily2 / 2) * A, -1)
    if pm.mod_q is not None:
        Q = torch.remainder(Q, pm.scal[0, 5])
    return Q


def phase_modes_kernel_vs_plain(dev, stdmap, pendulum, large):
    """The kernel's explicit update, Algorithm 2 and mod_p / pdiff modes
    against rollout_reference on the workloads' models (deployment jitter
    1e-5, as the workloads): float64 one step from each of 100 rows of the
    plain trajectory within 1e-12 (the free-running orbits of the standard
    map are chaotic: one ulp of p0 moves the plain version itself by O(1)
    within 50 steps, printed as ``plain_ulp_sensitivity``); float32 at
    steps 1-2 against the float64 rollout of the same float32 columns, the
    kernel's L2 error within 3x the plain version's (the standard map's
    models at jitter 1e-5 carry |alpha| ~ 9e3, and each float32 version
    lies 1e-4 to 3e-4 from float64 there), and the kernel within
    ATOL_F32_STDMAP of the plain version (the pendulum's within ATOL_F32);
    over the whole run, each trajectory's residual against one float64
    step from its own rows within 3x the plain version's, and the
    pendulum's mean Eosc.  Two wrong trajectories the gates must fail:
    pdiff summed from the wrapped P, and Algorithm 2's q update with the A
    factor left in.  standard_map_large's rollout held by
    ``_large_mode_check``.  Each mode timed at 32768 x 1000 at N=20 and
    the mod_p mode at 30 x 200 at N=4096."""
    from sympgpr_tpu_torch.eval import metrics
    from sympgpr_tpu_torch.ops import cuda_step as cs
    from sympgpr_tpu_torch.systems import pendulum as pend
    from sympgpr_tpu_torch.systems.standard_map import StandardMapConfig
    from sympgpr_tpu_torch.workloads import standard_map as wsm

    two_pi = 2 * math.pi
    (s_imp, a_imp), (s_exp, _) = stdmap["implicit"], stdmap["explicit"]
    s_pen, _ = pendulum["explicit"]
    sd_imp, ad_imp = s_imp.for_deployment(1e-5), a_imp.for_deployment(1e-5)
    sd_exp, sd_pen = s_exp.for_deployment(1e-5), s_pen.for_deployment(1e-5)
    # mode: (sgp, aux, mod_q, mod_p, rollout keywords, ICs, float32 rows:
    # the workload's nm)
    sm_ics = wsm.initial_conditions(StandardMapConfig(), dev)
    pen_ics = tuple(torch.tensor(x, dtype=torch.float64, device=dev)
                    for x in pend.test_initial_conditions(
                        pend.PendulumConfig()))
    modes = {
        "implicit_mod_p_pdiff": (sd_imp, ad_imp, two_pi, two_pi,
                                 dict(track_pdiff=True), sm_ics, 100),
        "explicit_product": (sd_imp, None, two_pi, two_pi,
                             dict(explicit=True, track_pdiff=True), sm_ics,
                             100),
        "sum_stdmap": (sd_exp, None, None, two_pi, dict(track_pdiff=True),
                       sm_ics, 100),
        "sum_pendulum": (sd_pen, None, two_pi, None, {}, pen_ics, NM),
    }
    res, wrong = {}, {}
    for name, (sgp, aux, mod_q, mod_p, kw, (q0, p0), nm32) in modes.items():
        r = res[name] = {"n_train": sgp.n_train, "f32_rows": nm32}
        for dtype in (torch.float64, torch.float32):
            pm = cs.pack_models(sgp, aux, mod_q=mod_q, mod_p=mod_p,
                                dtype=dtype)
            q, p = q0.to(dtype), p0.to(dtype)
            nm = 100 if dtype == torch.float64 else nm32
            got = cs.rollout_in_kernel(pm, q, p, nm, iters=8, **kw)
            sync()
            ref = cs.rollout_reference(pm, q, p, nm, iters=8, **kw)
            nan_equal = all(torch.equal(torch.isnan(g), torch.isnan(t))
                            for g, t in zip(got, ref))
            # the wrong trajectories, from the plain version's: Q of step
            # 1 with A in Algorithm 2's q update; pdiff summed from the
            # wrapped P, which telescopes to the wrapped P itself
            bad = {}
            if name.startswith("sum"):
                Qw = ref[0].clone()
                Qw[1] = _sum_q_with_A(pm, q, ref[1][1])
                bad["sum_q_with_A"] = (Qw,) + tuple(ref[1:])
            if mod_p is not None:
                bad["pdiff_from_wrapped_P"] = (ref[0], ref[1], ref[1])
            if dtype == torch.float64:
                per = rc.periods(pm, len(ref))
                for k, w in bad.items():  # rows 1-2 of the one-step gate
                    wrong[f"{k}_f64_{name}"] = (max(
                        rc.max_abs_diff(a[1:3], b[1:3], c)
                        for a, b, c in zip(w, ref, per)), ATOL_F64_STEP)
                r["f64_step_err_100_rows"] = _one_step_along(pm, ref, kw)
                r["f64_trajectory_err_100_steps"] = max(
                    rc.max_abs_diff(g, t, c)
                    for g, t, c in zip(got, ref, per))
                r["f64_nan_pattern_equal"] = nan_equal
                r["plain_ulp_sensitivity_steps_1_10_50_99"] = \
                    _ulp_sensitivity(pm, q, p, 100, kw)
                continue
            f32 = rc.f32_vs_f64(pm, q, p, kw, got, ref)
            err = f32.pop("err")
            r.update({f"f32_{k}": v for k, v in f32.items()})
            for k, w in bad.items():
                wrong[f"{k}_f32_{name}"] = (err(w), f32["err_bound"])
            if mod_p is None:
                H = [metrics.pendulum_energy(t[0], t[1]) for t in (got, ref)]
                r["f32_mean_Eosc_kernel_plain"] = [
                    float(np.nanmean(metrics.energy_oscillation(h).cpu()))
                    for h in H]

    # standard_map_large's rollout against its plain version
    s_large, a_large = large
    large_check = _large_mode_check(dev, s_large, a_large, sm_ics)

    # timings: 32768 x 1000 at N=20, and 30 x 200 at N=4096
    timing = {}
    shapes = [
        ("implicit_mod_p_pdiff_32768x1000_n20", sd_imp, ad_imp, two_pi,
         two_pi, dict(track_pdiff=True), MODES_BATCH, MODES_STEPS,
         "implicit"),
        ("explicit_product_32768x1000_n20", sd_imp, None, two_pi, two_pi,
         dict(explicit=True, track_pdiff=True), MODES_BATCH, MODES_STEPS,
         "explicit"),
        ("sum_32768x1000_n20", sd_exp, None, None, two_pi,
         dict(track_pdiff=True), MODES_BATCH, MODES_STEPS, "sum"),
        ("implicit_mod_p_pdiff_30x200_n4096", s_large, a_large, two_pi,
         two_pi, dict(track_pdiff=True), 30, 200, "implicit"),
    ]
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for (name, sgp, aux, mod_q, mod_p, kw, batch, nm, mode) in shapes:
        pm = cs.pack_models(sgp, aux, mod_q=mod_q, mod_p=mod_p)
        reps = -(-batch // 30)
        q = sm_ics[0].repeat(reps)[:batch].float().contiguous()
        p = sm_ics[1].repeat(reps)[:batch].float().contiguous()
        ms = _time(lambda: cs.rollout_in_kernel(pm, q, p, nm, iters=8, **kw))
        plain_ms = _time(lambda: cs.rollout_reference(pm, q, p, nm, iters=8,
                                                      **kw), reps=1)
        b = rollout_bound(batch, nm, sgp.n_train,
                          aux.X.shape[0] if aux is not None else 0, 4,
                          iters=8, mode=mode, pdiff=True)
        timing[name] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
            bound_by=b["bound_by"], bound_share=b["bound_ms"] / ms,
            orbit_steps_per_s=(nm - 1) * batch / (ms * 1e-3),
            geometry=cs.launch_geometry(
                batch, pm.ns, pm.nas, torch.float32, sm_count,
                mode=cs.kernel_mode(pm.kind, kw.get("explicit", False),
                                    pm.mod_p is not None,
                                    kw.get("track_pdiff", False))).__dict__)
    emit("modes_kernel_vs_plain", modes=res, wrong_trajectories=wrong,
         large_n4096=large_check, timing=timing, f64_atol=ATOL_F64_STEP,
         f32_atol=ATOL_F32, f32_atol_stdmap=ATOL_F32_STDMAP)
    for name, r in res.items():
        assert r["f64_nan_pattern_equal"] and r["f32_nan_pattern_equal"], r
        assert r["f64_step_err_100_rows"] <= ATOL_F64_STEP, (name, r)
        assert r["f32_err_kernel"] <= r["f32_err_bound"], (name, r)
        assert r["f32_residual_kernel"] <= r["f32_residual_bound"], (name, r)
        if name == "sum_pendulum":  # regular orbits, |alpha| ~ 1
            assert r["f64_trajectory_err_100_steps"] <= ATOL_F64, r
            assert r["f32_max_abs_err_steps_1_2"] <= ATOL_F32, r
            k, pl = r["f32_mean_Eosc_kernel_plain"]
            assert abs(k - pl) <= STATS_RTOL_F32 * pl, (name, r)
        else:
            assert r["f32_max_abs_err_steps_1_2"] <= ATOL_F32_STDMAP, r
    f32, f64 = large_check["f32"], large_check["f64"]
    assert f32["nan_pattern_equal"] and f64["nan_pattern_equal"], large_check
    assert f32["err_kernel"] <= f32["err_bound"], large_check
    assert f32["residual_kernel"] <= f32["residual_bound"], large_check
    assert f64["step_err_200_rows"] <= ATOL_F64, large_check
    # the gates fail both wrong trajectories
    for k, (e, gate) in wrong.items():
        assert e > gate, (k, e, gate)
    assert len(wrong) == 10, wrong
    return res, timing


# --- the Split instances of the explicit, Algorithm-2 and mod_p modes -------

SPLIT_MODES_ROWS = 200   # the gates' rows (30 orbits)
TWIN_K = 1.5  # the standard map's second fit: a map of another kick


def _shifted_twin(model):
    """The model with its training angles moved by 2 pi: per_se is
    2 pi-periodic in q, so the same map, from other columns."""
    import dataclasses

    shift = torch.tensor([2 * math.pi, 0.0], dtype=model.X.dtype,
                         device=model.X.device)
    return dataclasses.replace(model, X=model.X + shift)


def phase_split_modes_kernel_vs_plain(dev, stdmap, sm_large, split_models,
                                      one_map_timing):
    """The kernel's Split instances of the explicit update, Algorithm 2
    and mod_p / pdiff (csrc/rollout_split_modes.cu) on the models the
    smoke has fitted, each as a Split model of two or four sub-maps and
    as one map checked at the new q: the standard map's per_se fit (mod_p
    / pdiff, and its explicit product update) and sum_per_se fit
    (Algorithm 2) beside fits at k = 1.5, standard_map_large's N = 4096
    model beside its 2 pi-shifted twin, and the Split tokamak's four
    CMA-ES sub-maps with pdiff and the loss at the new q, on ICs near r =
    0.5.  Each layout is driven once through ``rollout_model`` (float32,
    the workloads' deployment jitter) with the launch counts zeroed just
    before.  Against the plain version: float64 one kernel step from each
    of the plain trajectory's 200 rows, by the sub-map that made the next
    row (``rc.step_err``), within 1e-12, NaN patterns equal; float32 within 3x the plain version's own error against
    float64 (``rc.f32_vs_f64``).  Two sub-maps of 4096 points are float32
    only: their float64 rows overflow a block's shared memory, and the
    kernel refuses them (float64 Split models take up to ~2300 points a
    sub-map at M = 2, ~1000 at M = 4).  Two wrong kernels the gates must fail:
    sub-map 0 on every step, and pdiff taken after the new q's NaN.  Two
    copies of one sub-map through the Split instance against the one-map
    instance.  Timings at 32768 x 1000, N = 20, beside the one-map
    instance of the same mode (``modes_kernel_vs_plain``), each bound by
    one sub-map's real training and aux points; the plain version of the
    two-sub-map layouts once, without a warm-up call."""
    from sympgpr_tpu_torch.ops import cuda_step as cs
    from sympgpr_tpu_torch.systems import tokamak as tk
    from sympgpr_tpu_torch.systems.standard_map import StandardMapConfig
    from sympgpr_tpu_torch.workloads import standard_map as wsm

    two_pi = 2 * math.pi
    t0 = time.perf_counter()
    twin = {m: wsm.run(StandardMapConfig(k=TWIN_K), method=m,
                       backend="kernel", device=dev)["models"]
            for m in ("implicit", "explicit")}
    twin_fit_s = time.perf_counter() - t0
    (s_imp, a_imp), (s_sum, _) = stdmap["implicit"], stdmap["explicit"]
    (t_imp, ta_imp), (t_sum, _) = twin["implicit"], twin["explicit"]
    s_large, a_large = sm_large
    sgps, auxes = split_models
    sm_ics = wsm.initial_conditions(StandardMapConfig(), dev)
    r0 = np.repeat(np.linspace(0.44, 0.5, 8), 8)
    th0 = np.tile(np.linspace(0.0, two_pi, 8, endpoint=False), 8)
    pth, qb = tk.ics_to_pth(r0, th0, dev)
    tok_ics = (qb, pth * _split_cfg().momentum_scale)
    # case: sub-maps, aux models, mod_q, mod_p, keywords, deployment
    # jitter, ICs, float64 gate
    cases = {
        "mod_p_pdiff": ([s_imp, t_imp], [a_imp, ta_imp], two_pi, two_pi,
                        {}, 1e-5, sm_ics, ATOL_F64_STEP),
        "explicit_product": ([s_imp, t_imp], [None, None], two_pi, two_pi,
                             dict(explicit=True), 1e-5, sm_ics,
                             ATOL_F64_STEP),
        "sum": ([s_sum, t_sum], [None, None], None, two_pi, {}, 1e-5,
                sm_ics, ATOL_F64_STEP),
        "n4096_mod_p_pdiff": ([s_large, _shifted_twin(s_large)],
                              [a_large, _shifted_twin(a_large)], two_pi,
                              two_pi, {}, None, sm_ics, ATOL_F64_STEP),
        "tokamak_split_pdiff": (list(sgps), list(auxes), two_pi, None,
                                dict(loss_check=True, loss_at_new_q=True),
                                1e-3, tok_ics, ATOL_F64_STEP),
    }
    layouts = {}
    for name, (ss, aa, mod_q, mod_p, kw, jit, ics, gate) in cases.items():
        kw = dict(kw, track_pdiff=True)
        layouts[f"{name}_m{len(ss)}"] = (ss, aa, mod_q, mod_p, kw, jit, ics,
                                         gate)
        layouts[f"{name}_m1_new_q"] = (ss[:1], aa[:1], mod_q, mod_p,
                                       dict(kw, loss_check=True,
                                            loss_at_new_q=True), jit, ics,
                                       gate)

    # the main path: each layout through the user's entry point, counted
    profiling.launch_counts(zero=True)
    driven = {}
    for name, (ss, aa, mod_q, mod_p, kw, jit, (q0, p0), _) in \
            layouts.items():
        out = cs.rollout_model(ss, aa, q0, p0, SPLIT_MODES_ROWS, mod_q=mod_q,
                               mod_p=mod_p, iters=8, deployment_jitter=jit,
                               **kw)
        driven[name] = dict(arity=len(out), shape=list(out[0].shape),
                            dtype=str(out[0].dtype),
                            finite_rows_1=bool(torch.isfinite(
                                out[2][1]).any()))
    sync()
    launches = profiling.launch_counts()["rollout"]

    res, wrong, packs = {}, {}, {}
    for name, (ss, aa, mod_q, mod_p, kw, jit, (q0, p0), gate) in \
            layouts.items():
        if jit is not None:
            ss = [s.for_deployment(jit) for s in ss]
            aa = [a.for_deployment(jit) if a is not None else None
                  for a in aa]
        r = res[name] = {"n_maps": len(ss), "f64_gate": gate}
        for dtype in (torch.float64, torch.float32):
            pm = cs.pack_models_split(ss, aa, mod_q=mod_q, mod_p=mod_p,
                                      dtype=dtype)
            r["library"] = cs._library(pm, kw.get("loss_at_new_q", False),
                                       kw.get("explicit", False), True)
            q, p = q0.to(dtype).contiguous(), p0.to(dtype).contiguous()
            if dtype == torch.float64 and name == "n4096_mod_p_pdiff_m2":
                # two sub-maps' rows of 4096 float64 points overflow a
                # block's shared memory: the kernel refuses them
                try:
                    cs.rollout_in_kernel(pm, q, p, 2, iters=8, **kw)
                except ValueError as e:
                    r["f64_refused"] = str(e)
                continue
            got = cs.rollout_in_kernel(pm, q, p, SPLIT_MODES_ROWS, iters=8,
                                       **kw)
            sync()
            ref = cs.rollout_reference(pm, q, p, SPLIT_MODES_ROWS, iters=8,
                                       **kw)
            lost = torch.isnan(ref[1])
            r["lost_plain_" + str(dtype)[6:]] = int(lost[-1].sum())
            if dtype == torch.float64:
                packs[name] = (ss, aa, q, p)
                r["f64_step_err_200_rows"] = _one_step_along(pm, ref, kw)
                r["f64_nan_pattern_equal"] = all(
                    torch.equal(torch.isnan(g), torch.isnan(t))
                    for g, t in zip(got, ref))
                # pdiff in the row an orbit is lost in: finite at the new
                # q, NaN at the old
                gone = lost[1:] & ~lost[:-1]
                r["pdiff_finite_in_lost_rows"] = int(
                    torch.isfinite(got[2][1:][gone]).sum())
                r["orbits_lost_in_run"] = int(gone.sum())
                if len(ss) > 1 and name.startswith(("mod_p", "explicit",
                                                    "sum", "tokamak")):
                    first = cs.pack_models_split(
                        [ss[0]] * len(ss), [aa[0]] * len(ss), mod_q=mod_q,
                        mod_p=mod_p, dtype=dtype)
                    wrong[f"submap0_f64_{name}"] = (
                        _one_step_along(first, ref, kw), gate)
                if kw.get("loss_at_new_q") and r["orbits_lost_in_run"]:
                    late = torch.where(lost, torch.nan, ref[2])
                    wrong[f"pdiff_after_new_q_nan_f64_{name}"] = (
                        rc.max_abs_diff(got[2], late), gate)
                continue
            f32 = rc.f32_vs_f64(pm, q, p, kw, got, ref)
            f32.pop("err")
            r.update({f"f32_{k}": v for k, v in f32.items()})

    # two copies of one sub-map through the Split instance against the
    # one-map instance (float64, the rows of the gates)
    copies = {}
    for name in ("mod_p_pdiff_m2", "explicit_product_m2", "sum_m2"):
        ss, aa, q, p = packs[name]
        mod_q, mod_p, kw = layouts[name][2:5]
        one, two = (cs.pack_models_split(ss[:1] * n, aa[:1] * n,
                                         mod_q=mod_q, mod_p=mod_p,
                                         dtype=torch.float64)
                    for n in (1, 2))
        a1, a2 = (cs.rollout_in_kernel(pm, q, p, SPLIT_MODES_ROWS, iters=8,
                                       **kw) for pm in (one, two))
        sync()
        explicit = kw.get("explicit", False)
        copies[name] = dict(
            max_abs_diff=max(rc.max_abs_diff(x, y) for x, y in zip(a1, a2)),
            bits_equal=all(torch.equal(x, y) for x, y in zip(a1, a2)),
            libraries=[cs._library(pm, False, explicit, True)
                       for pm in (one, two)])

    # timings: 32768 x 1000 at N = 20, float32
    timing = {}
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    reps = -(-MODES_BATCH // 30)
    q = sm_ics[0].repeat(reps)[:MODES_BATCH].float().contiguous()
    p = sm_ics[1].repeat(reps)[:MODES_BATCH].float().contiguous()
    for name, mode, one_map in (
            ("mod_p_pdiff", "implicit", "implicit_mod_p_pdiff_32768x1000_n20"),
            ("explicit_product", "explicit",
             "explicit_product_32768x1000_n20"),
            ("sum", "sum", "sum_32768x1000_n20")):
        for layout in (f"{name}_m2", f"{name}_m1_new_q"):
            ss, aa, mod_q, mod_p, kw, jit = layouts[layout][:6]
            pm = cs.pack_models_split(
                [s.for_deployment(jit) for s in ss],
                [a.for_deployment(jit) if a is not None else None
                 for a in aa], mod_q=mod_q, mod_p=mod_p)
            ms = _time(lambda: cs.rollout_in_kernel(pm, q, p, MODES_STEPS,
                                                    iters=8, **kw))
            # a step runs one sub-map of its real size (pm.ns is padded)
            b = rollout_bound(MODES_BATCH, MODES_STEPS,
                              max(s.n_train for s in ss),
                              max((a.X.shape[0] for a in aa if a is not None),
                                  default=0),
                              4, iters=8, n_maps=len(ss), mode=mode,
                              pdiff=True)
            t = timing[f"{layout}_32768x1000_n20"] = dict(
                ms=ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                bound_share=b["bound_ms"] / ms,
                one_map_instance_ms=one_map_timing[one_map]["ms"],
                geometry=cs.launch_geometry(
                    MODES_BATCH, pm.ns, pm.nas, torch.float32, sm_count,
                    n_maps=pm.n_maps,
                    loss_at_new_q=kw.get("loss_at_new_q", False)).__dict__)
            if layout.endswith("_m2"):  # one call: 0.6-4 s each
                t["plain_ms"] = _time(lambda: cs.rollout_reference(
                    pm, q, p, MODES_STEPS, iters=8, **kw), reps=1,
                    warmup=False)
    emit("split_modes_kernel_vs_plain", launches=launches, driven=driven,
         cases=res, wrong_kernels=wrong, copies=copies, timing=timing,
         twin_fit_s=twin_fit_s, f32_noise_factor=rc.NOISE_FACTOR)
    assert launches == len(layouts), launches
    for name, d in driven.items():
        assert d["arity"] == 3 and d["dtype"] == "torch.float32", (name, d)
        assert d["shape"][0] == SPLIT_MODES_ROWS and d["finite_rows_1"], d
    for name, r in res.items():
        assert r["library"] == "rollout_split_modes", (name, r)
        if name == "n4096_mod_p_pdiff_m2":
            assert "shared memory" in r.get("f64_refused", ""), (name, r)
        else:
            assert r["f64_nan_pattern_equal"], (name, r)
            assert r["f64_step_err_200_rows"] <= r["f64_gate"], (name, r)
        assert r["f32_err_kernel"] <= r["f32_err_bound"], (name, r)
        assert r["f32_residual_kernel"] <= r["f32_residual_bound"], (name, r)
        if not name.startswith("tokamak"):  # no orbit near the boundary
            assert r["f32_nan_pattern_equal"], (name, r)
    # point 3 on the card: lost at the new q, pdiff finite in that row
    for name in ("tokamak_split_pdiff_m4", "tokamak_split_pdiff_m1_new_q"):
        r = res[name]
        assert r["orbits_lost_in_run"] > 0, (name, r)
        assert r["pdiff_finite_in_lost_rows"] == r["orbits_lost_in_run"], r
    for k, (e, gate) in wrong.items():
        assert e > gate, (k, e, gate)
    assert len(wrong) == 6, wrong
    for name, c in copies.items():
        assert c["max_abs_diff"] <= ATOL_F64_STEP, (name, c)
        assert c["libraries"] == ["rollout_step", "rollout_split_modes"], c
    return launches, timing


# --- the headline benchmark (python -m sympgpr_tpu_torch bench) ------------

# the JAX package's bench.py:333-352, the detail's keys
BENCH_DETAIL_KEYS = [
    "device", "dtype", "fit_s", "cpu_baseline_steps_per_s",
    "ref_size_steps_per_s", "ref_size_speedup", "lost_orbits_10k",
    "rollout_mxu_reduce_steps_per_s", "large_n", "tokamak_large",
    "nuts_samples_per_s", "nuts_context", "compile_cache_dir",
    "total_bench_s"]
# large_n_main, large_main and posterior_parity run these stages at full
# size: the benchmark's own are cut to N = 1024 (tokamak_large: 10 Adam
# steps) through the JAX file's own variables; its rollouts stay full
BENCH_ENV = {"SYMPGPR_BENCH_LARGE_N": "1024",
             "SYMPGPR_BENCH_TOK_LARGE_N": "1024",
             "SYMPGPR_BENCH_TOK_LARGE_STEPS": "10"}
BENCH_TIMEOUT_S = 600
BENCH_CHECK_ROWS = 300    # the 10,000-step run's first rows, against plain
BENCH_CHECK_STRIDE = 10   # one step from every 10th row of the 10,000


def _bench_ref_size_check(dev, models) -> dict:
    """The benchmark's reference size in this process: ``bench.kernel_
    rollouts`` on the smoke's N = 80 maps (``main_kernel``'s fit of the
    benchmark's configuration), the launch counts zeroed just before and
    read just after, and its one 30 x 10,000 launch, which no other phase
    makes, held against the plain version: the first 300 rows within 3x
    the plain version's error against float64 (``rc.f32_vs_f64``), and,
    at every 10th row of the 10,000, the kernel's next row against one
    float64 step from that row within 3x the plain version's float32 step
    from it (``rc.residual``), NaN patterns equal."""
    from sympgpr_tpu_torch import bench
    from sympgpr_tpu_torch.ops import cuda_step as cs
    from sympgpr_tpu_torch.systems import tokamak as tk

    (sgp,), (aux,) = models
    q0, p0 = bench.initial_conditions(tk.TokamakConfig(), dev)
    profiling.launch_counts(zero=True)
    ref_rate, (Q, P), rate = bench.kernel_rollouts(sgp, aux, q0, p0)
    sync()
    launches = profiling.launch_counts()["rollout"]
    # the pack kernel_rollouts launches
    pm = cs.pack_models(sgp.for_deployment(1e-3), aux.for_deployment(1e-3),
                        mod_q=2 * math.pi)
    kw = dict(loss_check=True)
    q, p = q0.float().contiguous(), p0.float().contiguous()
    n = BENCH_CHECK_ROWS
    plain = cs.rollout_reference(pm, q, p, n, **kw)
    head = rc.f32_vs_f64(pm, q, p, kw, (Q[:n], P[:n]), plain)
    head.pop("err")
    rows = torch.arange(0, Q.shape[0] - 1, BENCH_CHECK_STRIDE, device=dev)
    qs, ps = (t[rows].reshape(-1).contiguous() for t in (Q, P))
    nxt = [t[rows + 1].reshape(-1) for t in (Q, P)]
    one = cs.rollout_reference(pm, qs, ps, 2, **kw)
    spread = dict(
        rows=len(rows), finite_rows=int(torch.isfinite(ps).sum()),
        nan_pattern_equal=all(torch.equal(torch.isnan(a), torch.isnan(b[1]))
                              for a, b in zip(nxt, one)),
        residual_kernel=rc.residual(
            pm, tuple(torch.stack([x, y]) for x, y in zip((qs, ps), nxt)),
            kw),
        residual_plain=rc.residual(
            pm, tuple(torch.stack([x, y[1]]) for x, y in zip((qs, ps), one)),
            kw))
    spread["residual_bound"] = rc.NOISE_FACTOR * spread["residual_plain"]
    return dict(launches=launches, steps=list(Q.shape),
                ref_size_steps_per_s=ref_rate, throughput_steps_per_s=rate,
                lost=int(torch.isnan(P[-1]).sum()), first_rows=head,
                every_10th_row=spread)


def phase_bench_main(dev, smi: str, models) -> dict:
    """``python -m sympgpr_tpu_torch bench --device cuda`` in a process of
    its own (the kernels built by ``build``): its last line is the headline
    with a finite value above 0 and a vs_baseline, the line before it the
    detail with the JAX file's keys, float32 on this card, ``lost_orbits_
    10k`` within the reference size's gate, the large-N stages and NUTS
    run; its standard error's last line gives the run's kernel launches
    (counted from 0 in that process) and the reference-size run's mean
    Eosc.  Then the reference size's launch in this process, held against
    the plain version (``_bench_ref_size_check``); its launches join the
    process's."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sympgpr_tpu_torch", "bench", "--device",
         "cuda"], capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
        env=dict(os.environ, **BENCH_ENV))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"bench exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    head = json.loads(lines[-1])
    detail = json.loads(lines[-2])["detail"]
    diag = json.loads(proc.stderr.strip().splitlines()[-1])
    large, tok = detail["large_n"], detail["tokamak_large"]
    emit("bench_main", wall_s=wall, headline=head, env=BENCH_ENV,
         launches=diag["launches"],
         ref_size_mean_Eosc=diag["ref_size_mean_Eosc"],
         detail={k: v for k, v in detail.items()
                 if k not in ("large_n", "tokamak_large")},
         large_n={k: large[k] for k in ("N", "build_s", "chol_s",
                                       "train_step_s", "launches")
                  if k in large},
         tokamak_large={k: tok[k] for k in (
             "N", "fit_s", "gd", "mean_Eosc", "n_lost", "rollout_ms",
             "rollout_steps_per_s") if k in tok},
         nvidia_smi=smi)
    check = _bench_ref_size_check(dev, models)
    emit("bench_main_ref_size", **check)
    assert list(head) == ["metric", "value", "unit", "vs_baseline"], head
    assert head["metric"] == "tokamak_rollout_orbit_steps_per_s", head
    assert math.isfinite(head["value"]) and head["value"] > 0, head
    assert math.isfinite(head["vs_baseline"]) and head["vs_baseline"] > 0
    assert list(detail) == BENCH_DETAIL_KEYS, list(detail)
    assert detail["dtype"] == "float32", detail["dtype"]
    assert torch.cuda.get_device_name(0) in detail["device"], detail
    assert detail["rollout_mxu_reduce_steps_per_s"] is None
    assert detail["lost_orbits_10k"] <= GATE_LOST, detail
    assert math.isfinite(diag["ref_size_mean_Eosc"]), diag
    assert isinstance(large, dict) and isinstance(tok, dict)
    assert detail["nuts_samples_per_s"] > 0, detail
    for k in profiling.KERNELS:
        assert diag["launches"][k] > 0, f"bench launched no {k} kernel"
    f32, spread = check["first_rows"], check["every_10th_row"]
    assert check["launches"] > 0, check
    assert check["steps"] == [10_000, 30] and check["lost"] <= GATE_LOST
    assert f32["nan_pattern_equal"] and spread["nan_pattern_equal"], check
    assert f32["err_kernel"] <= f32["err_bound"], check
    assert f32["residual_kernel"] <= f32["residual_bound"], check
    assert spread["finite_rows"] > 0, check
    assert spread["residual_kernel"] <= spread["residual_bound"], check
    return dict(diag["launches"],
                rollout=diag["launches"]["rollout"] + check["launches"])


# --- the perturbed pendulum and Henon-Heiles ---------------------------------

# workload -> (training-error gate, float32 one-step MSE gate, float64
# one-step MSE of RESULTS.md:12 / :15 (CPU, float64), held within 2x); the
# gates are those of tests/test_workloads.py (the Pallas ones for float32)
PERT_HENON = {
    "pert_pendulum": (1e-10, 1e-3, 1.1e-7),
    "henon_heiles": (1e-12, 2e-3, 1.9e-5),
}
# the generic autodiff map path against the fast path on the card: float64
# rows within 1e-12 + 1e-12 |row| (the CPU tests' tolerance)
GENERIC_STEPS = 5
TOL_GENERIC = 1e-12


def _pert_henon_run(name: str, backend: str, dev) -> dict:
    """One run of the workload at its RESULTS.md configuration (the
    perturbed pendulum: N = 55 before the disc filter, 30 orbits, nm =
    100; Henon-Heiles: N = 55, 37 orbits, nm = 500)."""
    if name == "pert_pendulum":
        from sympgpr_tpu_torch.systems.pert_pendulum import \
            PertPendulumConfig
        from sympgpr_tpu_torch.workloads import pert_pendulum as wl

        return wl.run(PertPendulumConfig(), backend=backend, device=dev)
    from sympgpr_tpu_torch.systems.henon_heiles import HenonConfig
    from sympgpr_tpu_torch.workloads import henon_heiles as wl

    return wl.run(HenonConfig(), backend=backend, device=dev)


def _stage_times(out: dict, prefix: str = "") -> dict:
    return {f"{prefix}{k}": out[k]
            for k in ("t_data", "t_train", "t_apply", "t_reference")}


def _device_kernels(fn) -> int | None:
    """Kernels the card ran for ``fn()`` (``torch.profiler``), or None
    where the profiler records no device events."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    cuda = torch.autograd.DeviceType.CUDA
    n = sum(e.count for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda)
    return n or None


def _integrator_launches(dev) -> dict:
    """Kernels a step of the two eager integrators launches: each run
    for 100 and for 200 steps under the profiler; the difference over 100
    steps is a step's, the rest the run's fixed part (the Henon-Heiles
    polish of all crossings at once), and the launches of the workloads'
    data and reference runs follow from them."""
    from sympgpr_tpu_torch.systems import henon_heiles as hh
    from sympgpr_tpu_torch.systems import pert_pendulum as pp

    cfg_h, cfg_p = hh.HenonConfig(), pp.PertPendulumConfig()
    z_h = torch.tensor(hh.training_ics(cfg_h), dtype=torch.float64,
                       device=dev)
    z_p = torch.tensor(pp.gen_samples_circle([0.0, 0.0], cfg_p.radius,
                                             cfg_p.N), dtype=torch.float64,
                       device=dev)
    runs = {"henon_integrate_sections":
            lambda n: hh.integrate_sections(cfg_h, z_h, n, 2),
            "pert_rk_pmap": lambda n: pp.rk_pmap(z_p, cfg_p.e, cfg_p.om, n)}
    # the workloads' runs: steps of each integrator
    uses = {"henon_integrate_sections": {
                "training_3000": int(4 * 7.5 / cfg_h.dt),
                "reference_8_cuts_7500": int(10 * 7.5 / cfg_h.dt)},
            "pert_rk_pmap": {
                "training_1500": cfg_p.rk_steps_train,
                "reference_99_periods": (cfg_p.nm - 1) * cfg_p.rk_steps_test}}
    out = {}
    for name, fn in runs.items():
        fn(100)  # warm-up
        n100, n200 = _device_kernels(lambda: fn(100)), \
            _device_kernels(lambda: fn(200))
        if n100 is None or n200 is None:
            out[name] = None
            continue
        per_step = (n200 - n100) / 100
        fixed = n100 - 100 * per_step
        out[name] = dict(per_step=per_step, fixed=fixed, **{
            k: fixed + per_step * n for k, n in uses[name].items()})
    return out


def phase_pert_henon_main(dev):
    """pert_pendulum and henon_heiles at RESULTS.md's configurations
    through the kernel backend (float32: the periodic instance with an aux
    model of the absolute P at deployment jitter 1e-5; the SE x SE
    instance without a wrap of q at 1e-3) and the float64 generic
    backend."""
    res, models = {}, {}
    profiling.launch_counts(zero=True)
    for name in PERT_HENON:
        out = _pert_henon_run(name, "kernel", dev)
        t = out["traj"]
        res[name] = dict(
            training_error=out["training_error"],
            one_step_mse=out["one_step_mse"], hyp=out["hyp"].tolist(),
            n_train=int(out["models"][0].n_train),
            finite=bool(torch.isfinite(t.q).all() & torch.isfinite(t.p)
                        .all()),
            dtype=str(t.q.dtype), shape=list(t.q.shape),
            **_stage_times(out))
        models[name] = out["models"]
    launches = profiling.launch_counts()["rollout"]
    for name in PERT_HENON:
        out = _pert_henon_run(name, "generic", dev)
        res[name].update(
            f64_one_step_mse=out["one_step_mse"],
            f64_training_error=out["training_error"],
            f64_dtype=str(out["traj"].q.dtype),
            **_stage_times(out, "f64_"))
    data_launches = _integrator_launches(dev)
    emit("pert_henon_main", launches=launches, data_launches=data_launches,
         gates={k: v[:2] for k, v in PERT_HENON.items()},
         results_rows={k: v[2] for k, v in PERT_HENON.items()}, **res)
    assert launches == 2, "the two workloads launched no rollout kernel"
    for name, (gate_train, gate32, row) in PERT_HENON.items():
        r = res[name]
        assert r["dtype"] == "torch.float32" and r["finite"], (name, r)
        assert r["f64_dtype"] == "torch.float64", (name, r)
        assert r["training_error"] < gate_train, (name, r)
        assert r["f64_training_error"] < gate_train, (name, r)
        assert r["one_step_mse"] < gate32, (name, r)
        assert 0.5 <= r["f64_one_step_mse"] / row <= 2.0, (name, r)
    return models, launches


def _workload_ics(name: str, dev):
    """The workload's test ICs, float64 on ``dev``."""
    f64 = dict(dtype=torch.float64, device=dev)
    if name == "pert_pendulum":
        from sympgpr_tpu_torch.systems import pert_pendulum as pp

        return tuple(torch.tensor(x, **f64) for x in
                     pp.test_initial_conditions(pp.PertPendulumConfig()))
    from sympgpr_tpu_torch.systems import henon_heiles as hh

    cfg = hh.HenonConfig()
    z0 = hh.test_ics(cfg)
    return (torch.tensor(z0[:, 1] * cfg.scale, **f64),
            torch.tensor(z0[:, 3] * cfg.scale, **f64))


def phase_pert_henon_kernel_vs_plain(dev, models):
    """The kernel against rollout_reference on both workloads' fitted
    models, deployed as the workloads deploy them, over the workloads' ICs
    and rows (30 x 100 and 37 x 500): the same NaN patterns; float64 one
    step from each plain row within ATOL_F64; float32 at steps 1-2 against
    the float64 rollout of the same float32 columns, and each
    trajectory's residual against one float64 step from its own rows, the
    kernel's L2 within 3x the plain version's
    (``rollout_check.f32_vs_f64``).  Each float32 rollout (the workload's
    5 Newton iterations) timed beside its plain version and its bound.
    The generic autodiff path against the fast path for GENERIC_STEPS
    steps of the Henon-Heiles model in float64."""
    from sympgpr_tpu_torch.maps.symplectic import MapConfig, apply_map
    from sympgpr_tpu_torch.ops import cuda_step as cs

    # workload: (deployment jitter, mod_q, rows)
    setup = {"pert_pendulum": (1e-5, 2 * math.pi, 100),
             "henon_heiles": (1e-3, None, 500)}
    res, timing = {}, {}
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (jitter, mod_q, nm) in setup.items():
        sgp, aux = models[name]
        sd, ad = sgp.for_deployment(jitter), aux.for_deployment(jitter)
        q0, p0 = _workload_ics(name, dev)
        r = res[name] = {"n_train": sgp.n_train, "rows": nm}
        for dtype in (torch.float64, torch.float32):
            pm = cs.pack_models(sd, ad, mod_q=mod_q, dtype=dtype)
            q, p = q0.to(dtype), p0.to(dtype)
            got = cs.rollout_in_kernel(pm, q, p, nm, iters=8)
            sync()
            ref = cs.rollout_reference(pm, q, p, nm, iters=8)
            nan_equal = all(torch.equal(torch.isnan(g), torch.isnan(t))
                            for g, t in zip(got, ref))
            if dtype == torch.float64:
                r["f64_step_err_all_rows"] = _one_step_along(pm, ref, {})
                r["f64_trajectory_err"] = max(
                    rc.max_abs_diff(g, t, c)
                    for g, t, c in zip(got, ref, rc.periods(pm, 2)))
                r["f64_nan_pattern_equal"] = nan_equal
                continue
            f32 = rc.f32_vs_f64(pm, q, p, {}, got, ref)
            f32.pop("err")
            r.update({f"f32_{k}": v for k, v in f32.items()})
        # timing: the workload's float32 rollout (5 Newton iterations)
        pm = cs.pack_models(sd, ad, mod_q=mod_q)
        q, p = q0.float().contiguous(), p0.float().contiguous()
        ms = _time(lambda: cs.rollout_in_kernel(pm, q, p, nm))
        plain_ms = _time(lambda: cs.rollout_reference(pm, q, p, nm))
        b = rollout_bound(q.shape[0], nm, sgp.n_train, aux.X.shape[0], 4)
        timing[f"{name}_{q.shape[0]}x{nm}_n{sgp.n_train}"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
            bound_by=b["bound_by"], bound_share=b["bound_ms"] / ms,
            geometry=cs.launch_geometry(q.shape[0], pm.ns, pm.nas,
                                        torch.float32, sm_count).__dict__)

    # the generic autodiff path on the card, against the fast path
    sgp, aux = models["henon_heiles"]
    q0, p0 = _workload_ics("henon_heiles", dev)
    cfg = MapConfig(mod_q=None, newton_tol=1e-12, newton_maxiter=20)
    t0 = time.perf_counter()
    gen = apply_map(sgp, aux, q0, p0, GENERIC_STEPS + 1, cfg,
                    prefer_fast=False)
    sync()
    t_generic = time.perf_counter() - t0
    fast = apply_map(sgp, aux, q0, p0, GENERIC_STEPS + 1, cfg)
    excess = max(float(((g - f).abs() - TOL_GENERIC * (1 + f.abs())).max())
                 for g, f in zip(gen[:2], fast[:2]))
    generic = dict(steps=GENERIC_STEPS, device=str(gen.q.device),
                   dtype=str(gen.q.dtype), t_s=t_generic,
                   max_abs_diff=max(rc.max_abs_diff(g, f)
                                    for g, f in zip(gen[:2], fast[:2])),
                   excess_over_tol=excess)
    emit("pert_henon_kernel_vs_plain", models=res, timing=timing,
         generic_vs_fast=generic, f64_atol=ATOL_F64)
    for name, r in res.items():
        assert r["f64_nan_pattern_equal"] and r["f32_nan_pattern_equal"], r
        assert r["f64_step_err_all_rows"] <= ATOL_F64, (name, r)
        assert r["f32_err_kernel"] <= r["f32_err_bound"], (name, r)
        assert r["f32_residual_kernel"] <= r["f32_residual_bound"], (name, r)
    assert generic["device"].startswith("cuda"), generic
    assert generic["dtype"] == "torch.float64", generic
    assert excess <= 0.0, generic
    return timing


# --- slice E: samplers, Adam, Sobol (float64; no kernel of the repo) --------

# card against CPU tensors for one transition on the pendulum posterior,
# whose Ky is conditioned near 1e10: (rtol, atol) of the state, of its
# log-probability and of the accept statistic (the CPU tests measured JAX
# against the port at 6.1e-10, 8.3e-9 and 3.0e-6 there; an accept
# probability below 1e-30 is held absolutely)
TRANSITION_TOL = {"x": (1e-8, 0.0), "lp": (1e-7, 0.0),
                  "alpha": (1e-5, 1e-12)}
SOBOL_QOI_RTOL = 1e-10  # the QoI on the card against CPU tensors
# a batched Adam row against its one-set fit: the Split sets fit at sig2n
# 1e-14, where the batched NLL (two triangular solves) and the one-row NLL
# (cholesky_solve) round apart; 300 steps move theta 2.1e-9 apart on the
# CPU
ADAM_ROW_RTOL = 1e-8


def _counting(logprob, counter: dict):
    """``logprob`` with its calls (one value and gradient a call in the
    samplers) counted in ``counter["evals"]``."""
    def fn(x):
        counter["evals"] += 1
        return logprob(x)
    return fn


def _syncs(fn) -> int:
    """Host syncs the CUDA runtime reports while ``fn()`` runs."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            fn()
            sync()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(x.message) for x in w)


def _transition_on(device, logprob, kind: str, draws_seed: int = 5):
    """One HMC (16 steps) or NUTS (max depth 6) transition of 4 pendulum
    chains from fixed draws (numpy, seed ``draws_seed``) on ``device``;
    returns (its outputs in numpy, the host syncs of the transition alone,
    or None on the CPU)."""
    from sympgpr_tpu_torch.gp import hmc, nuts

    rng = np.random.default_rng(draws_seed)
    x0 = np.array([[1.7, 1.2, 2.5], [1.5, 1.0, 1.5], [2.0, 1.4, 3.5],
                   [1.8, 1.1, 2.0]])
    eps = np.array([0.002, 0.01, 0.04, 0.1])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    x = t(x0)
    lp, g = hmc.value_and_grad(logprob, x)
    if kind == "hmc":
        args = (logprob, x, lp, g, t(eps), t(rng.standard_normal((4, 3))),
                t(rng.uniform(size=4)), 16)
        fn, keys = hmc.hmc_transition, ("x", "lp", "g", "accept", "alpha")
    else:
        d = nuts.NUTSDraws(t(rng.standard_normal((4, 3))),
                           t(2 * rng.integers(0, 2, (4, 6)) - 1),
                           t(rng.uniform(size=(4, 128))),
                           t(rng.uniform(size=(4, 6))))
        args = (logprob, x, lp, g, t(eps), d, 6)
        fn = nuts.nuts_transition
        keys = ("x", "lp", "g", "alpha", "depth", "diverging")
    out, n_syncs = None, None
    if device.type == "cuda":
        sync()
        res = []
        n_syncs = _syncs(lambda: res.append(fn(*args)))
        out = res[0]
    else:
        out = fn(*args)
    return {k: v.cpu().numpy() for k, v in zip(keys, out)}, n_syncs


def phase_posterior_parity(dev):
    """The pendulum N = 18 hyperposterior on the card: the 40^3 quadrature
    through nll_batched, NUTS 4 x 250 and adaptive HMC 4 x 600 held to the
    four gates of tests/test_posterior_parity.py
    (``sympgpr_tpu_torch/eval/posterior.py``); one HMC and one NUTS
    transition from fixed draws on the card against CPU tensors, and the
    host syncs of each."""
    from sympgpr_tpu_torch.eval import posterior as post
    from sympgpr_tpu_torch.gp import hmc, nuts

    profiling.launch_counts(zero=True)
    prob = post.pendulum_problem(dev)
    res = {"n_train": int(prob["X"].shape[0])}
    t0 = time.perf_counter()
    quad = post.quadrature(prob["logprob"], dev)
    sync()
    res["quadrature"] = dict(points=len(quad["G"]), s=time.perf_counter() - t0,
                             edge_mass=quad["edge_mass"],
                             mean=quad["mean"].tolist(),
                             std=quad["std"].tolist())
    samples = {}
    for name, run, std_rtol in (("nuts", post.run_nuts, post.NUTS_STD_RTOL),
                                ("hmc", post.run_hmc, post.HMC_STD_RTOL)):
        counter = {"evals": 0}
        lp = _counting(prob["logprob"], counter)
        t0 = time.perf_counter()
        r = run(lp, dev)
        sync()
        wall = time.perf_counter() - t0
        cfg = post.NUTS_RUN if name == "nuts" else post.HMC_RUN
        transitions = cfg["n_samples"] + cfg["n_warmup"]
        s = r.samples.cpu().numpy().reshape(-1, 3)
        samples[name] = s
        accept = r.accept_stat if name == "nuts" else r.accept_rate
        res[name] = dict(
            s=wall, accept=accept.cpu().numpy().tolist(),
            evals=counter["evals"],
            evals_per_transition=counter["evals"] / transitions,
            ms_per_eval=1e3 * wall / counter["evals"],
            device=str(r.samples.device),
            gate=post.moment_check(s, quad, std_rtol))
        if name == "nuts":
            res[name].update(mean_depth=r.mean_depth.cpu().numpy().tolist(),
                             divergences=int(r.n_divergent.sum()))
    res["bands"] = post.bands_check(prob, samples["nuts"], quad)
    res["coverage"] = post.coverage_check(prob)

    def logprob_of(device, counter=None):
        lp = hmc.nll_logprob(post.PER_SE, prob["X"].to(device),
                             prob["z"].to(device), post.SIG2N)
        return lp if counter is None else _counting(lp, counter)

    trans = {}
    for kind in ("hmc", "nuts"):
        counter = {"evals": 0}
        gpu, n_syncs = _transition_on(dev, logprob_of(dev, counter), kind)
        cpu, _ = _transition_on(torch.device("cpu"),
                                logprob_of(torch.device("cpu")), kind)
        rel = {k: float(np.max(np.abs(gpu[k] - cpu[k])
                               / np.maximum(np.abs(cpu[k]), 1e-300)))
               for k in TRANSITION_TOL}
        excess = {k: float(np.max(np.abs(gpu[k] - cpu[k]) - rtol
                                  * np.abs(cpu[k]) - atol))
                  for k, (rtol, atol) in TRANSITION_TOL.items()}
        exact = [k for k in gpu if k not in ("x", "lp", "g", "alpha")]
        # the evaluations of the transition: all but the start point's
        trans[kind] = dict(rel_err=rel, excess_over_tol=excess,
                           exact_equal={
            k: bool(np.array_equal(gpu[k], cpu[k])) for k in exact},
            syncs=n_syncs, evals=counter["evals"] - 1,
            depth=gpu["depth"].tolist() if kind == "nuts" else None)
    res["transition_gpu_vs_cpu"] = trans
    res["kernel_launches"] = profiling.launch_counts()
    emit("posterior_parity", **res)
    assert res["quadrature"]["edge_mass"] < 1e-3, res["quadrature"]
    assert min(res["nuts"]["accept"]) > post.NUTS_MIN_ACCEPT, res["nuts"]
    assert min(res["hmc"]["accept"]) > post.HMC_MIN_ACCEPT, res["hmc"]
    for name in ("nuts", "hmc"):
        assert res[name]["gate"]["ok"], (name, res[name])
        assert res[name]["device"].startswith("cuda"), res[name]
    assert res["bands"]["ok"] and res["coverage"]["ok"], res
    for kind, tr in trans.items():
        assert all(tr["exact_equal"].values()), (kind, tr)
        assert max(tr["excess_over_tol"].values()) <= 0.0, (kind, tr)
        # the known host reads: one a log-probability call (the NLL's
        # failed rows), and for NUTS one a leapfrog step of its inner loop
        # and one a doubling (its outer loop, at most max_depth + 1)
        known = tr["evals"] + (tr["evals"] + 7 if kind == "nuts" else 0)
        assert tr["syncs"] <= known, (kind, tr)
    assert not any(res["kernel_launches"].values()), res["kernel_launches"]


# transitions of sample_main (the CLI's defaults are 200 + 200): cut to an
# eighth to keep the smoke within half its time limit, the sampler being
# bound by eager dispatch on the host (4.5-8.3 ms an evaluation on an H100)
SAMPLE_MAIN_CUT = ["--samples", "25", "--warmup", "25"]


def phase_sample_main(dev):
    """The CLI's ``sample`` at its defaults but for SAMPLE_MAIN_CUT (8
    chains, 25 + 25): NUTS on tokamak (N = 80, K 160 x 160), adaptive HMC
    on pendulum_implicit."""
    from sympgpr_tpu_torch import __main__ as cli
    from sympgpr_tpu_torch.gp import hmc

    res = {}
    nll_logprob = hmc.nll_logprob
    for workload, sampler in (("tokamak", "nuts"),
                              ("pendulum_implicit", "hmc")):
        counter = {"evals": 0}
        hmc.nll_logprob = lambda *a, **k: _counting(nll_logprob(*a, **k),
                                                    counter)
        profiling.launch_counts(zero=True)
        args = cli.build_parser().parse_args(
            ["sample", workload, "--sampler", sampler, "--device", str(dev)]
            + SAMPLE_MAIN_CUT)
        t0 = time.perf_counter()
        try:
            out, r = cli.cmd_sample(args)
            sync()
        finally:
            hmc.nll_logprob = nll_logprob
        wall = time.perf_counter() - t0
        res[workload] = dict(
            cli=out, s=wall, evals=counter["evals"],
            ms_per_eval=1e3 * wall / counter["evals"],
            log_probs_finite=bool(torch.isfinite(r.log_probs).all()),
            device=str(r.samples.device),
            kernel_launches=profiling.launch_counts())
    emit("sample_main", **res)
    for workload, r in res.items():
        assert r["log_probs_finite"], (workload, r)
        assert r["cli"]["accept_rate"] > 0.5, (workload, r)
        assert r["device"].startswith("cuda"), (workload, r)
        assert not any(r["kernel_launches"].values()), (workload, r)


def phase_sobol_main(dev):
    """The CLI's ``sobol`` at its defaults (n = 128, 30 turns: 512 QoI rows
    x 960 steps) on the card; the QoI on the card against CPU tensors at
    n = 8, 2 turns."""
    from sympgpr_tpu_torch import __main__ as cli
    from sympgpr_tpu_torch import sensitivity as sens

    profiling.launch_counts(zero=True)
    args = cli.build_parser().parse_args(["sobol", "--device", str(dev)])
    t0 = time.perf_counter()
    out = cli.cmd_sobol(args)
    sync()
    wall = time.perf_counter() - t0
    launches = profiling.launch_counts()
    design = sens.saltelli_sample(8, [(0.0, 0.004), (0.0, 2 * np.pi)])
    qoi = sens.tokamak_chaos_qoi(n_turns=2)
    t0 = time.perf_counter()
    on_card = qoi(torch.as_tensor(design, device=dev)).cpu().numpy()
    t_small = time.perf_counter() - t0
    on_cpu = qoi(torch.as_tensor(design)).numpy()
    rel = float(np.max(np.abs(on_card - on_cpu) / np.abs(on_cpu)))
    # kernels a step, by the profiler over 4 steps of 2 rows
    kernels = _device_kernels(lambda: sens.tokamak_chaos_qoi(
        n_turns=1, nph=4)(torch.as_tensor(design[:2], device=dev)))
    emit("sobol_main", cli=out, s=wall, rows=len(sens.saltelli_sample(
        args.n, [(0, 1), (0, 1)])), steps=32 * args.turns,
        qoi_card_vs_cpu_rel=rel, small_s=t_small,
        kernels_per_step=None if kernels is None else kernels / 4,
        kernel_launches=launches)
    vals = np.asarray(out["S1"] + out["ST"])
    assert np.all(np.isfinite(vals)), out
    assert np.all((vals >= -0.1) & (vals <= 1.1)), out
    assert rel <= SOBOL_QOI_RTOL, rel
    assert not any(launches.values()), launches


def phase_adam_main(dev, split_sets, lbfgs_models):
    """fit_batch_adam over the Split tokamak's four sub-map training sets
    (N = 70 each, 300 steps, the sympl fit's linear transform from (0.5,
    0.5, 10)), each row against minimize_adam on its set; then
    ``run tokamak_kernel --optimizer adam`` (one rollout launch), its NLL
    beside L-BFGS's of the main path."""
    from sympgpr_tpu_torch.gp import likelihood
    from sympgpr_tpu_torch.gp import train
    from sympgpr_tpu_torch.kernels import PER_SE
    from sympgpr_tpu_torch.systems import tokamak as tk
    from sympgpr_tpu_torch.workloads import tokamak as wl

    Xs, zs, sig2n = split_sets
    kw = dict(transform="linear", steps=300)
    x0 = (0.5, 0.5, 10.0)
    profiling.launch_counts(zero=True)
    t0 = time.perf_counter()
    thetas, nlls = train.fit_batch_adam(PER_SE, Xs, zs, sig2n=sig2n, x0=x0,
                                        **kw)
    sync()
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = []
    for m in range(Xs.shape[0]):
        obj = train.make_objective(likelihood.nll, PER_SE, Xs[m], zs[m],
                                   sig2n, transform="linear")
        rows.append(train.minimize_adam(obj, x0, steps=300, device=dev))
    t_rows = time.perf_counter() - t0
    th = thetas.cpu().numpy()
    rel = max(float(np.max(np.abs(th[m] - r.theta) / np.abs(r.theta)))
              for m, r in enumerate(rows))
    rel_nll = max(abs(float(nlls[m]) - r.fun) / abs(r.fun)
                  for m, r in enumerate(rows))
    batch_launches = profiling.launch_counts()

    cfg = tk.TokamakConfig()
    profiling.launch_counts(zero=True)
    t0 = time.perf_counter()
    out = wl.run(cfg, optimizer="adam", backend="kernel",
                 with_reference=False, device=dev)
    sync()
    t_run = time.perf_counter() - t0
    launches = profiling.launch_counts()["rollout"]
    (r0, th0), _ = tk.test_initial_conditions(cfg)
    out.update(wl.one_turn_gd(cfg, out["traj"], r0, th0, dev))

    def nll_of(sgp):
        with torch.no_grad():
            return float(likelihood.nll(PER_SE, sgp.params, sgp.sig,
                                        torch.as_tensor(cfg.sig2_n,
                                                        device=dev),
                                        sgp.X, sgp.z))

    sgp = out["models"][0][0]
    res = dict(
        batch=dict(sets=int(Xs.shape[0]), n_train=int(Xs.shape[1]),
                   steps=300, s=t_batch, rows_s=t_rows,
                   max_rel_theta_vs_rows=rel, max_rel_nll_vs_rows=rel_nll,
                   thetas=th.tolist(), nlls=nlls.cpu().numpy().tolist(),
                   kernel_launches=batch_launches),
        tokamak_kernel_adam=dict(
            training_error=out["training_error"],
            median_gd=float(np.nanmedian(out["gd"])),
            mean_gd=float(np.nanmean(out["gd"])), n_lost=out["n_lost"],
            nll=nll_of(sgp), nll_lbfgs=nll_of(lbfgs_models[0][0]),
            hyps=out["hyps"][0].tolist(), sig=out["sigs"][0],
            t_train=out["t_train"], t_apply=out["t_apply"], s=t_run,
            launches=launches))
    emit("adam_main", **res)
    assert rel <= ADAM_ROW_RTOL and rel_nll <= ADAM_ROW_RTOL, res["batch"]
    assert np.all(np.isfinite(th)), res["batch"]
    assert not any(batch_launches.values()), batch_launches
    r = res["tokamak_kernel_adam"]
    assert launches == 1, r
    assert np.isfinite(r["nll"]) and np.isfinite(r["training_error"]), r
    return launches


# --- slice F: distribution -----------------------------------------------------

# the distributed fit at the BENCH_r05 N (K 8192^2 in float32, 20 Adam steps
# of the workload's defaults), and the parity size of the two-rank float64
# run (K 2048^2)
DIST_N, DIST_STEPS = 4096, 20
DIST_PARITY_N, DIST_BLOCK, DIST_SIG2N = 1024, 64, 1e-2
# the keys of sympgpr_tpu/workloads/large_n.py::run_distributed's summary
# (:124-145; the parity keys only at N <= parity_limit = 2048)
JAX_DIST_KEYS = {"N", "devices", "mesh", "dtype", "steps", "nll_first",
                 "nll_last", "nll_decreased", "hyp", "sig", "t_train_s",
                 "t_train_warm_s", "per_device_K_bytes", "checkpoint"}
# gates of the float32 distributed fit on the card: its alpha against a
# dense float64 solve at the fitted theta (relative to max |alpha|; H100:
# 1.05e-4), and its gradient at theta0 against the float64 closed form
# (relative L2; H100: 4.0e-4, where the single-device fit's cuSOLVER
# factor gives 1.3e-2 and its gate is 5e-2), each about 10x the reading
DIST_ALPHA_RTOL = 1e-3
DIST_GRAD_RTOL = 5e-3
# two ranks against one in float64: value, gradient and alpha (relative)
DIST_RANKS_RTOL = 1e-10
# sample_nuts_sharded over the two ranks: 4 chains x (10 + 10) transitions
# of the pendulum_implicit posterior
DIST_CHAINS, DIST_WARMUP, DIST_SAMPLES = 4, 10, 10


def _dist_problem(dev, dtype, N):
    """(X, z, theta0, sig2n) of run_distributed's synthetic problem."""
    from sympgpr_tpu_torch.workloads import large_n

    X, z = large_n.synthetic_training_set(N, dtype, device=dev)
    theta = torch.tensor(large_n.DIST_X0, dtype=dtype, device=dev)
    return X, z, theta, torch.tensor(DIST_SIG2N, dtype=dtype, device=dev)


def _dist_f64_case(mesh, dev) -> dict:
    """The float64 value, gradient and alpha at theta0, N = 1024."""
    from sympgpr_tpu_torch.distributed import large
    from sympgpr_tpu_torch.kernels import PER_SE

    X, z, theta, s2n = _dist_problem(dev, torch.float64, DIST_PARITY_N)
    v, g = large.sharded_nll_large_value_and_grad(
        PER_SE, mesh, theta, s2n, X, z, block=DIST_BLOCK)
    hyp = 10.0 ** theta
    a = large.sharded_alpha_large(PER_SE, mesh, hyp[:-1], hyp[-1], s2n, X, z,
                                  block=DIST_BLOCK)
    return dict(v=v.cpu(), g=g.cpu(), alpha=a.cpu())


def _dist_sampler(dev):
    """(logprob, x0s) of the pendulum_implicit posterior, the CLI's."""
    from sympgpr_tpu_torch import __main__ as cli
    from sympgpr_tpu_torch.gp import hmc

    kern, X, z, sig2n, x0 = cli._sample_problem("pendulum_implicit", dev)
    x0s = torch.as_tensor(hmc.start_points(x0, DIST_CHAINS, 0),
                          dtype=torch.float64, device=dev)
    return hmc.nll_logprob(kern, X, z, sig2n), x0s


def dist_rank(rank: int, out: str) -> None:
    """One of two ranks sharing the card under gloo (``--dist-rank``): the
    float64 fit quantities, the bench batch through
    ``rollout_in_kernel_sharded`` (its kernel launches counted around that
    one call) and ``sample_nuts_sharded``; saves them for the parent."""
    from torch.distributed.device_mesh import init_device_mesh

    from sympgpr_tpu_torch.distributed import init as dinit
    from sympgpr_tpu_torch.distributed.sharded import \
        rollout_in_kernel_sharded
    from sympgpr_tpu_torch.gp.nuts import sample_nuts_sharded

    dev = dinit.initialize("cuda:0", backend="gloo",
                           init_method=f"file://{out}/rendezvous",
                           world_size=2, rank=rank)
    try:
        kp = init_device_mesh("cuda", (2,), mesh_dim_names=("kp",))
        dp = init_device_mesh("cuda", (2,), mesh_dim_names=("dp",))
        res = {"backend": torch.distributed.get_backend()}
        t0 = time.perf_counter()
        res["f64"] = _dist_f64_case(kp, dev)
        res["f64_s"] = time.perf_counter() - t0
        roll = torch.load(f"{out}/rollout.pt", weights_only=False)
        pm, q0, p0 = roll["pm"], roll["q0"], roll["p0"]
        profiling.launch_counts(zero=True)
        Q, P = rollout_in_kernel_sharded(dp, pm, q0, p0, NM, loss_check=True)
        sync()
        res["launches"] = profiling.launch_counts()
        res["rows"] = (Q[:3].cpu(), P[:3].cpu())
        res["lost"] = int(torch.isnan(P[-1]).sum())
        res["finite"] = bool(torch.isfinite(Q[:, ~torch.isnan(P[-1])]).all())
        res["rollout_ms"] = _time(lambda: rollout_in_kernel_sharded(
            dp, pm, q0, p0, NM, loss_check=True))
        logprob, x0s = _dist_sampler(dev)
        t0 = time.perf_counter()
        nuts = sample_nuts_sharded(logprob, x0s, kp, DIST_SAMPLES,
                                   n_warmup=DIST_WARMUP, seed=0)
        sync()
        res["nuts_s"] = time.perf_counter() - t0
        res["nuts"] = tuple(t.cpu() for t in nuts)
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dinit.shutdown()


def phase_distributed_main(dev, pm32) -> int:
    """Slice F on the card.  (a) ``run large_n --distributed`` at N = 4096,
    20 steps, one rank on NCCL in float32, in its own process: the NLL
    falls, the JAX keys, the distributed alpha against a dense float64
    solve at the fitted theta; in this process on a world of one rank, the
    float32 distributed gradient at theta0 against the float64 closed
    form, and the factorization and one value and gradient timed.  (b) two
    ranks sharing the card under gloo (CUDA tensors staged through the
    host): the float64 value, gradient and alpha at N = 1024 against this
    process's one-rank run; the bench batch (32768 x 1000, N = 80) through
    ``rollout_in_kernel_sharded``, each rank's kernel columns held by
    ``ops/rollout_check.py`` to the one-process kernel run and to the plain
    version; ``sample_nuts_sharded`` equal to the per-shard runs.  Returns
    the ranks' rollout launches."""
    import shutil
    import tempfile

    from torch.distributed.device_mesh import init_device_mesh

    from sympgpr_tpu_torch.distributed import init as dinit
    from sympgpr_tpu_torch.distributed import large
    from sympgpr_tpu_torch.gp import likelihood
    from sympgpr_tpu_torch.gp.covariance import build_K_fast
    from sympgpr_tpu_torch.gp.model import load_models
    from sympgpr_tpu_torch.gp.nuts import sample_nuts
    from sympgpr_tpu_torch.kernels import PER_SE
    from sympgpr_tpu_torch.ops import cuda_step as cs

    t_phase = time.perf_counter()
    out = tempfile.mkdtemp(prefix="sympgpr_dist_")
    # (b) starts first: its ranks reach the card while (a) runs
    q0, p0 = _ics(dev, torch.float32, math.ceil(BENCH_ORBITS / 30))
    q0, p0 = q0[:BENCH_ORBITS].contiguous(), p0[:BENCH_ORBITS].contiguous()
    torch.save({"pm": pm32, "q0": q0, "p0": p0}, f"{out}/rollout.pt")
    logs = [open(f"{out}/rank{r}.log", "w") for r in range(2)]
    ranks = [subprocess.Popen([sys.executable, __file__, "--dist-rank",
                               str(r), out], stdout=log,
                              stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]

    # (a) the CLI's distributed fit, one rank on NCCL
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "sympgpr_tpu_torch", "run", "large_n",
         "--distributed", "--n", str(DIST_N), "--steps", str(DIST_STEPS),
         "--device", "cuda"], capture_output=True, text=True, timeout=600)
    fit_wall = time.perf_counter() - t0
    assert r.returncode == 0, r.stderr[-3000:]
    fit = json.loads(r.stdout.strip().splitlines()[-1])
    model, _, _ = load_models(fit["checkpoint"], dev)
    X64, z64 = model.X.double(), model.z.double()
    params64, sig64 = model.params.double(), model.sig.double()
    Ky = build_K_fast(PER_SE, X64, X64, params64, sig64)
    Ky.diagonal().add_(model.sig2n.double())
    a64 = torch.cholesky_solve(z64[:, None], torch.linalg.cholesky(Ky))[:, 0]
    del Ky
    alpha_rel = float((model.alpha.double() - a64).abs().max()
                      / a64.abs().max())

    # this process: a world of one rank on NCCL
    dinit.initialize(dev)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("kp",))
        X, z, theta, s2n = _dist_problem(dev, torch.float32, DIST_N)
        v32, g32 = large.sharded_nll_large_value_and_grad(
            PER_SE, mesh, theta, s2n, X, z, block=DIST_BLOCK)
        X, z, theta64, s2n64 = _dist_problem(dev, torch.float64, DIST_N)
        v64, g64 = likelihood.nll_value_and_grad_theta(PER_SE, theta64,
                                                       s2n64, X, z)
        grad_rel = float((g32.double() - g64).norm() / g64.norm())
        value_rel = float(abs(float(v32) - float(v64)) / abs(float(v64)))
        X, z, theta, s2n = _dist_problem(dev, torch.float32, DIST_N)
        group = mesh.get_group("kp")
        n_pad, nb, nb_loc = large._geometry(DIST_N, 1, DIST_BLOCK)
        hyp = 10.0 ** theta
        slab = large.build_K_cyclic(PER_SE, mesh, hyp[:-1], hyp[-1], s2n, X,
                                    block=DIST_BLOCK)[0]
        factor_ms = _time(lambda: large._factorize_robust(
            slab, None, 2 * DIST_N, 0, group, 1, nb, nb_loc, DIST_BLOCK))
        vg_ms = _time(lambda: large.sharded_nll_large_value_and_grad(
            PER_SE, mesh, theta, s2n, X, z, block=DIST_BLOCK), reps=2)
        del slab, X, z
        one = _dist_f64_case(mesh, dev)
    finally:
        dinit.shutdown()

    # (b) the two ranks' results against one process
    for p in ranks:
        try:
            p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            for q in ranks:
                q.kill()
            raise
    for r, p in enumerate(ranks):
        logs[r].close()
        assert p.returncode == 0, open(f"{out}/rank{r}.log").read()[-3000:]
    got = [torch.load(f"{out}/rank{r}.pt", weights_only=False)
           for r in range(2)]
    f64 = [dict(value_rel=abs(float(g["f64"]["v"]) / float(one["v"]) - 1),
                grad_rel=float((g["f64"]["g"] - one["g"]).abs().max()
                               / one["g"].abs().max()),
                alpha_rel=float((g["f64"]["alpha"] - one["alpha"]).abs().max()
                                / one["alpha"].abs().max()))
           for g in got]
    Q1, P1 = cs.rollout_in_kernel(pm32, q0, p0, NM, loss_check=True)
    sync()
    half = BENCH_ORBITS // 2
    kw = {"loss_check": True}
    roll = []
    for rk, g in enumerate(got):
        cols = slice(rk * half, rk * half + 32)
        q, p = q0[cols].contiguous(), p0[cols].contiguous()
        mine = tuple(t[:, :32].to(dev) for t in g["rows"])
        one_proc = (Q1[:3, cols], P1[:3, cols])
        plain = cs.rollout_reference(pm32, q, p, 3, **kw)
        vs_one = rc.f32_vs_f64(pm32, q, p, kw, mine, one_proc)
        vs_plain = rc.f32_vs_f64(pm32, q, p, kw, mine, plain)
        vs_one.pop("err")
        vs_plain.pop("err")
        shard = slice(rk * half, (rk + 1) * half)
        roll.append(dict(
            vs_one_process=vs_one, vs_plain=vs_plain,
            rows_equal_one_process=all(
                torch.equal(t.to(dev), o[:3, shard])
                for t, o in zip(g["rows"], (Q1, P1))),
            lost=g["lost"], lost_one_process=int(
                torch.isnan(P1[-1, shard]).sum()),
            finite=g["finite"], ms=g["rollout_ms"],
            launches=g["launches"]["rollout"]))
    logprob, x0s = _dist_sampler(dev)
    shards = [sample_nuts(logprob, x0s[2 * rk:2 * rk + 2], DIST_SAMPLES,
                          n_warmup=DIST_WARMUP, seed=rk) for rk in range(2)]
    want = [torch.cat(f).cpu() for f in zip(*shards)]
    nuts_equal = [all(torch.equal(a, b) for a, b in zip(g["nuts"], want))
                  for g in got]
    one_ms = _time(lambda: cs.rollout_in_kernel(pm32, q0, p0, NM,
                                                loss_check=True))
    res = dict(
        fit=fit, fit_process_s=fit_wall,
        fit_ms_per_step=1e3 * fit["t_train_warm_s"] / (DIST_STEPS - 1),
        alpha_vs_dense_f64_rel=alpha_rel, alpha_gate=DIST_ALPHA_RTOL,
        grad_f32_vs_f64_rel=grad_rel, value_f32_vs_f64_rel=value_rel,
        grad_gate=DIST_GRAD_RTOL, factor_ms=factor_ms, value_and_grad_ms=vg_ms,
        ranks_backend=[g["backend"] for g in got],
        ranks_f64=f64, ranks_f64_s=[g["f64_s"] for g in got],
        ranks_gate=DIST_RANKS_RTOL, rollout=roll,
        rollout_one_process_ms=one_ms, nuts_equal=nuts_equal,
        nuts_s=[g["nuts_s"] for g in got],
        nuts_accept=float(want[2].mean()),
        wall_s=time.perf_counter() - t_phase)
    emit("distributed_main", **res)
    shutil.rmtree(out)
    assert set(fit) == JAX_DIST_KEYS, sorted(fit)
    assert fit["devices"] == 1 and fit["mesh"] == "nccl", fit
    assert fit["dtype"] == "float32" and fit["nll_decreased"], fit
    assert np.all(np.isfinite(fit["hyp"])) and math.isfinite(fit["sig"]), fit
    assert alpha_rel <= DIST_ALPHA_RTOL, alpha_rel
    assert grad_rel <= DIST_GRAD_RTOL, grad_rel
    assert res["ranks_backend"] == ["gloo", "gloo"], res["ranks_backend"]
    for f in f64:
        assert max(f.values()) <= DIST_RANKS_RTOL, f
    for r in roll:
        assert r["launches"] == 1 and r["finite"], r
        for check in (r["vs_one_process"], r["vs_plain"]):
            assert check["nan_pattern_equal"], check
            assert check["err_kernel"] <= check["err_bound"], check
            assert check["residual_kernel"] <= check["residual_bound"], check
    assert all(nuts_equal), nuts_equal
    return sum(r["launches"] for r in roll)


def main() -> None:
    dev, smi = phase_device()
    # the plain versions are the yardstick: full float32 matrix products
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on"
    phase_build()
    out, launches = phase_main_kernel(dev)
    phase_main_generic(dev)
    pm32, err32, ms, plain_ms = phase_kernel_vs_plain(dev, out["models"])
    phase_throughput(dev, pm32)
    split, split_launches = phase_split_main(dev)
    phase_split_generic(dev, split["models"])
    phase_split_kernel_vs_plain(dev, split["models"])
    split_models = split["models"]
    split_sets = (torch.stack([s.X for s in split["models"][0]]),
                  torch.stack([s.z for s in split["models"][0]]),
                  _split_cfg().sig2_n)
    del split
    large_models, large_launches = phase_large_main(dev)
    large = phase_large_kernels_vs_plain(dev, large_models[0])
    phase_rollout_shapes(dev, pm32, large_models)
    del large_models
    large_n_launches = phase_large_n_main(dev)
    phase_escalation(dev)
    stdmap, stdmap_launches = phase_stdmap_main(dev)
    pendulum, pendulum_launches = phase_pendulum_main(dev)
    sm_large, sm_large_launches = phase_stdmap_large(dev)
    _, modes_timing = phase_modes_kernel_vs_plain(dev, stdmap, pendulum,
                                                  sm_large)
    split_modes_launches, _ = phase_split_modes_kernel_vs_plain(
        dev, stdmap, sm_large, split_models, modes_timing)
    bench_launches = phase_bench_main(dev, smi, out["models"])
    pert_henon, pert_henon_launches = phase_pert_henon_main(dev)
    phase_pert_henon_kernel_vs_plain(dev, pert_henon)
    phase_posterior_parity(dev)
    phase_sample_main(dev)
    phase_sobol_main(dev)
    adam_launches = phase_adam_main(dev, split_sets, out["models"])
    dist_launches = phase_distributed_main(dev, pm32)
    b = rollout_bound(30, NM, pm32.ns, pm32.nas, 4)
    rows = [{"name": "rollout_step", "route": "cuda", "source": KERNEL_SOURCE,
             "replaces": REPLACES,
             "launches": launches + split_launches + stdmap_launches
             + pendulum_launches + sm_large_launches["rollout"]
             + pert_henon_launches + adam_launches
             + large_n_launches["rollout"] + dist_launches
             + split_modes_launches + bench_launches["rollout"],
             "max_abs_err": err32, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "library_ms": None}]
    for name, (source, replaces) in LARGE_SOURCES.items():
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": large_launches[name]
                     + sm_large_launches[name] + large_n_launches[name]
                     + bench_launches[name],
                     **large[name]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        dist_rank(int(sys.argv[2]), sys.argv[3])
    else:
        main()
