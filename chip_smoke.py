#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``sympgpr_tpu_torch``).

Builds every hand-written CUDA kernel from the checkout's sources (one nvcc
per source, all at once) and drives two main paths on the card:

* the tokamak workload at the reference configuration (N=80 training
  crossings, 30 test orbits, nm=1000) through the rollout kernel;
* the large-N tokamak workload (``tokamak_large``: N=4096 real crossings,
  60 Adam steps over the closed-form NLL gradient in float32, 30 orbits
  over nm=1000) through the covariance build and contraction, triangular
  matmul, syrk and rollout kernels.

Each kernel is held against its plain PyTorch version at the main path's
shapes, and both are timed with CUDA events.

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
    ptxas = {}
    for name in LIBRARIES:
        log = _build.library_path(name).with_suffix(".log")
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln or "spill" in ln][:24]
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


# --- the large-N path (tokamak_large) ----------------------------------------

# the fit settings the BENCH_r05 tokamak_large row ended with (sig2n 1e-2
# after its escalation, 60 steps), at its N
LARGE = dict(n_train=4096, nm=1000, steps=60, sig2n=1e-2, aux_subsample=512,
             rollout_batch=4096)
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
    sgp, aux = out.pop("models")
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
    return sgp, launches


def _rel_to_max(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def _contraction_check(X, params, sig, Kbar, got) -> dict:
    """L2 errors of a contraction ``got`` against the plain version in
    float64 on the same inputs, beside the errors of the plain version in
    the inputs' dtype, of an all-zero output and of a sum over the pairs
    of only the first half of the points."""
    from sympgpr_tpu_torch.ops import cuda_cov

    def plain(X, params, sig, Kbar):
        dp, ds = cuda_cov.cov_param_grads_reference("per_se", X, X, params,
                                                    sig, Kbar)
        return torch.cat([dp.double(), ds.double()[None]])

    X64, p64, s64, K64 = (t.double() for t in (X, params, sig, Kbar))
    ref = plain(X64, p64, s64, K64)
    N = X.shape[0]
    half = K64.clone()
    half[N // 2:N] = 0
    half[N + N // 2:] = 0
    got = torch.cat([got[0].double(), got[1].double()[None]])

    def err(v):
        return float((v - ref).norm())

    return dict(ref=ref.tolist(), got=got.tolist(), err=err(got),
                max_abs_err=float((got - ref).abs().max()),
                plain_err=err(plain(X, params, sig, Kbar)),
                zero_err=err(torch.zeros_like(ref)),
                half_pairs_err=err(plain(X64, p64, s64, half)),
                ref_norm=float(ref.norm()))


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

    K = cuda_cov.build_K_blocks("per_se", X, X, params, sig)
    Kp = cuda_cov.build_K_blocks_reference("per_se", X, X, params, sig)
    res["build_rel_err"] = _rel_to_max(K, Kp)
    kernels["cov_fwd"] = dict(
        max_abs_err=float((K - Kp).abs().max()),
        ms=_time(lambda: cuda_cov.build_K_blocks("per_se", X, X, params,
                                                 sig)),
        plain_ms=_time(lambda: cuda_cov.build_K_blocks_reference(
            "per_se", X, X, params, sig)))
    del Kp

    # the run's fit-step intermediates at the trained hyperparameters
    Ky = K + s2n * torch.eye(n, dtype=K.dtype, device=dev)
    L, info = torch.linalg.cholesky_ex(Ky)
    assert int(info) == 0, "Cholesky failed at the trained hyperparameters"
    alpha = torch.cholesky_solve(z[:, None], L)[:, 0]

    calls = []  # every trimm product of one tri_inv_blocked, recorded
    right, left = cuda_trimm.matmul_tril_right, cuda_trimm.matmul_tril_left
    cuda_trimm.matmul_tril_right = \
        lambda A, B: calls.append(("right", A, B)) or right(A, B)
    cuda_trimm.matmul_tril_left = \
        lambda A, B: calls.append(("left", A, B)) or left(A, B)
    try:
        W = triangular.tri_inv_blocked(L).contiguous()
    finally:
        cuda_trimm.matmul_tril_right, cuda_trimm.matmul_tril_left = \
            right, left
    trimm_err, trimm_rel, trimm_ms, trimm_plain_ms, levels = 0.0, 0.0, 0, 0, []
    for side, A, B in calls:
        fn = right if side == "right" else left
        ref_fn = (cuda_trimm.matmul_tril_right_reference if side == "right"
                  else cuda_trimm.matmul_tril_left_reference)
        C, Cp = fn(A, B), ref_fn(A, B)
        absA, absB = (A.abs(), B.abs().tril()) if side == "right" \
            else (A.abs().tril(), B.abs())
        bound = float(torch.matmul(absA, absB).max())
        e = float((C - Cp).abs().max())
        trimm_err, trimm_rel = max(trimm_err, e), max(trimm_rel, e / bound)
        ms = _time(lambda: fn(A, B))
        pms = _time(lambda: ref_fn(A, B))
        trimm_ms += ms
        trimm_plain_ms += pms
        levels.append(dict(side=side, shape=list(A.shape), ms=ms,
                           plain_ms=pms))
    res["trimm_levels"] = levels
    res["trimm_rel_err"] = trimm_rel
    kernels["trimm"] = dict(max_abs_err=trimm_err, ms=trimm_ms,
                            plain_ms=trimm_plain_ms)

    S = cuda_syrk.syrk_lower(W)
    S64 = cuda_syrk.syrk_lower_reference(W.double())
    res["syrk_rel_err"] = _rel_to_max(S, S64)
    res["syrk_plain_f32_rel_err"] = _rel_to_max(
        cuda_syrk.syrk_lower_reference(W), S64)
    kernels["syrk"] = dict(
        max_abs_err=float((S.double() - S64).abs().max()),
        ms=_time(lambda: cuda_syrk.syrk_lower(W)),
        plain_ms=_time(lambda: cuda_syrk.syrk_lower_reference(W)))
    del S64

    Kbar = 0.5 * S - 0.5 * torch.outer(alpha, alpha)
    got = cuda_cov.cov_param_grads("per_se", X, X, params, sig, Kbar)
    contraction = _contraction_check(X, params, sig, Kbar, got)
    contraction["bound"] = CONTRACT_NOISE_FACTOR * contraction["plain_err"]
    res["contraction"] = contraction
    kernels["cov_bwd"] = dict(
        max_abs_err=contraction["max_abs_err"],
        ms=_time(lambda: cuda_cov.cov_param_grads("per_se", X, X, params,
                                                  sig, Kbar)),
        plain_ms=_time(lambda: cuda_cov.cov_param_grads_reference(
            "per_se", X, X, params, sig, Kbar)))

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
    del K, Ky, L, W, S, Kbar

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
    Kb64 = torch.randn(512, 512, generator=g, dtype=torch.float64).to(dev)
    got64 = cuda_cov.cov_param_grads("per_se", X64, X64, p64, s64, Kb64)
    c64 = _contraction_check(X64, p64, s64, Kb64, got64)
    f64["contraction"] = c64["err"] / c64["ref_norm"]
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
    assert contraction["err"] <= contraction["bound"], contraction
    # the bound would fail a kernel that returns zeros or sums half the pairs
    assert min(contraction["zero_err"],
               contraction["half_pairs_err"]) > contraction["bound"], \
        contraction
    assert res["syrk_rel_err"] <= RTOL_SYRK_F32, res
    assert trimm_rel <= RTOL_TRIMM_F32, res
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
    sgp, large_launches = phase_large_main(dev)
    large = phase_large_kernels_vs_plain(dev, sgp)
    del sgp
    phase_escalation(dev)
    rows = [{"name": "rollout_step", "route": "cuda", "source": KERNEL_SOURCE,
             "replaces": REPLACES, "launches": launches,
             "max_abs_err": err32, "ms": ms, "plain_ms": plain_ms}]
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
