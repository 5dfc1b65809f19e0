"""Large-N pipeline measurement: covariance build, Cholesky, NLL and
training steps at training-set sizes far beyond the reference's N <= 80
(PyTorch port of ``sympgpr_tpu/workloads/large_n.py``).

``measure`` times each stage of the large-N fit on one device with one
timer, ``profiling.best_ms`` (CUDA events on the card, the host clock on
the CPU):

* the covariance build (``ops/cuda_cov.py::build_Ky``: the build kernel on
  the card, its plain version on the CPU);
* the Cholesky factorization (cuSOLVER on the card), the NLL evaluation
  (build, factor, solve), one step of the closed-form gradient
  (``gp/likelihood.py::nll_value_and_grad_theta``: build, contraction,
  syrk and triangular-matmul kernels) and one autodiff step (``BuildK``,
  whose backward is the general contraction kernel, then autograd through
  the Cholesky);
* a short Adam run (``gp/train.py::adam_update``), the end-to-end check
  that the fit trains;
* on the card, the triangular inverse and the syrk alone, and the
  deployment rollout of the trained model through the rollout kernel.

``rollout_sweep`` times the rollout kernel over training-set sizes on
synthetic models.  ``run_distributed`` trains the same synthetic problem
block-cyclically over the ranks of ``torch.distributed``
(``distributed/large.py::fit_large``).  The JAX package's chained in-jit scans (a TPU timing
workaround) and its TPU peak probes are not ported: every timed call is
one eager call, and ``measure`` returns times and work counts, not shares
of a peak.

Run: ``python -m sympgpr_tpu_torch bench --large-n --n 4096 --device
cuda``, ``python -m sympgpr_tpu_torch bench --rollout-sweep --device
cuda`` or ``python -m sympgpr_tpu_torch run large_n --device cuda``; the
distributed fit: ``python -m sympgpr_tpu_torch run large_n --distributed
--device cuda`` (one rank) or ``python -m torch.distributed.run
--nproc-per-node <gpus> -m sympgpr_tpu_torch run large_n --distributed``.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Iterator

import numpy as np
import torch

from sympgpr_tpu_torch import profiling
from sympgpr_tpu_torch.kernels import PER_SE
from sympgpr_tpu_torch.ops import cuda_step, rollout_check
from sympgpr_tpu_torch.systems.halton import halton

Tensor = torch.Tensor

# the measured model: short lengthscales keep K well-conditioned enough
# for the float32 Cholesky at this scale (with the deployment-scale jitter)
P0 = (0.35, 0.35)
SIG0 = 2.0
ADAM_LR = 3e-2
ROLLOUT_B, ROLLOUT_NM, ROLLOUT_ITERS = 4096, 256, 5
# the kernels each stage of ``measure`` launches on the card (its
# ``launches``): the build, the contractions, the syrk, the triangular
# matmul, the closed-form step's alpha product, the rollout
STAGE_KERNELS = {
    "build": {"cov_fwd"},
    "cholesky": set(),
    "nll_eval": {"cov_fwd"},
    "train_step": {"cov_fwd", "cov_bwd", "syrk", "trimm", "matvec"},
    "train_step_autodiff": {"cov_fwd", "cov_bwd"},
    "adam": {"cov_fwd", "cov_bwd", "syrk", "trimm", "matvec"},
    "triinv": {"trimm"},
    "syrk": {"syrk"},
    "rollout": {"rollout"},
}
# the sweep's synthetic models: lx, ly, alx, aly, delta, mod_q
SWEEP_SCAL = (0.6, 0.6, 0.6, 0.6, 1.0, 2 * np.pi)
SWEEP_AUX = 64
# the float32 gradients at N=4096 against float64 (relative L2): each path
# alone, and the closed form against autodiff, which share the build, Ky
# and the float32 Cholesky (H100: 1.3e-2 each, 1e-5 apart).  The shared
# error is cuSOLVER's float32 Cholesky: its backward error is 3.3e-6
# against LAPACK's 4.2e-7 on the same Ky, and with LAPACK's factor both
# gradients lie 3.7e-4 from float64 (tools/large_n_grad_witness.py)
GRAD_RTOL = 5e-2
GRAD_RTOL_PATHS = 1e-3


def synthetic_training_set(N: int, dtype: torch.dtype = torch.float32,
                           eps: float = 0.12, *,
                           device: torch.device | str = "cuda"):
    """Derivative-GP training pairs from an analytic generating function.

    F(q, P) = P^2/2 + eps cos(q) gives the standard-map-like targets
    z = (dF/dq, dF/dP) = (-eps sin q, P) at N Halton points; the fit is a
    real regression problem (recoverable structure), not throughput
    filler.  Returns (X (N, 2), z (2N,)).
    """
    H = halton(N, 2)
    q = 2.0 * np.pi * H[:, 0]
    P = 2.0 * (H[:, 1] - 0.5)
    X = torch.as_tensor(np.stack([q, P], 1), dtype=dtype, device=device)
    z = torch.as_tensor(np.concatenate([-eps * np.sin(q), P]), dtype=dtype,
                        device=device)
    return X, z


def sweep_models(N: int, B: int, rng: np.random.Generator,
                 device: torch.device | str):
    """One synthetic float32 rollout instance of the sweep: (pm, q0, p0).

    Draws from ``rng`` in the JAX package's order (uq, uP, a0, a1, auxq,
    auxp, auxa, then q0 and p0), so the columns equal its sweep's."""
    ns, nas = cuda_step._pad8(N), cuda_step._pad8(SWEEP_AUX)

    def col(v):
        return torch.as_tensor(np.asarray(v, np.float32).reshape(-1),
                               device=device)

    scal = np.zeros((1, cuda_step.NSCAL), np.float32)
    scal[0, :6] = SWEEP_SCAL
    pm = cuda_step.PackedModels(
        uq=col(rng.uniform(0, 2 * np.pi, ns)),
        uP=col(rng.uniform(-1, 1, ns)),
        a0=col(rng.normal(size=ns) / ns),
        a1=col(rng.normal(size=ns) / ns),
        auxq=col(rng.uniform(0, 2 * np.pi, nas)),
        auxp=col(rng.uniform(-1, 1, nas)),
        auxa=col(rng.normal(size=nas) / nas),
        scal=torch.as_tensor(scal, device=device),
        kind=0, aux_kind=0, ns=ns, nas=nas, delta=True,
        mod_q=float(SWEEP_SCAL[5]), mod_p=None)
    q0 = col(rng.uniform(0, 2 * np.pi, B))
    p0 = col(rng.uniform(-1, 1, B))
    return pm, q0, p0


def sweep_instances(Ns, B: int, device: torch.device | str
                    ) -> Iterator[tuple[int, object, Tensor, Tensor]]:
    """(N, pm, q0, p0) for each N of the sweep, from one
    ``np.random.default_rng(0)`` stream as in the JAX package."""
    rng = np.random.default_rng(0)
    for N in Ns:
        yield (N, *sweep_models(N, B, rng, device))


def rollout_sweep(Ns=(512, 1024, 2048, 4096), B: int = 4096, nm: int = 256,
                  *, device: torch.device | str = "cuda") -> dict:
    """Fused-rollout throughput against training-set size.

    Synthetic packed models at each N (``sweep_instances``); each rollout
    of B orbits over nm steps (5 Newton iterations, no loss check) is
    timed by ``profiling.best_ms``.  On the card the sweep spans the
    kernel's instances that ``ops/cuda_step.py::launch_geometry`` picks,
    up to ``cuda_step.ns_max(float32)`` training points.  Unlike the JAX
    package's sweep, no exception is caught: a size the kernel refuses, or
    a launch that fails, raises, so a kernel that cannot run is never
    written into the result as a string.
    """
    device = torch.device(device)
    out = {"B": B, "nm": nm}
    for N, pm, q0, p0 in sweep_instances(Ns, B, device):
        ms = profiling.best_ms(
            lambda: cuda_step.rollout_in_kernel(pm, q0, p0, nm),
            device=device)
        out[f"N{N}_ms"] = ms
        out[f"N{N}_steps_per_s"] = (nm - 1) * B / (ms * 1e-3)
        out[f"N{N}_pair_gsteps_per_s"] = (nm - 1) * B * pm.ns / (ms * 1e-3
                                                                  ) / 1e9
    return out


def sweep_check(pm, q0: Tensor, p0: Tensor, orbits: int = 32,
                steps: int = 2) -> dict:
    """One float32 rollout instance (a sweep's, or ``measure``'s
    deployment) held to its plain version: the rollout of all of q0 over
    ``steps`` steps (the timed launch's geometry), its first ``orbits``
    orbits against ``rollout_reference`` on them, both against the float64
    rollout of the same columns by ``ops/rollout_check.py::f32_vs_f64``.
    ``ok`` where the NaN patterns agree and the kernel's L2 error and
    residual lie within ``NOISE_FACTOR`` times the plain version's."""
    nm = steps + 1
    got = tuple(t[:, :orbits] for t in
                cuda_step.rollout_in_kernel(pm, q0, p0, nm))
    q0, p0 = q0[:orbits].contiguous(), p0[:orbits].contiguous()
    ref = cuda_step.rollout_reference(pm, q0, p0, nm)
    res = rollout_check.f32_vs_f64(pm, q0, p0, {}, got, ref)
    res.pop("err")
    res.update(orbits=orbits, steps=steps)
    res["ok"] = bool(res["nan_pattern_equal"]
                     and res["err_kernel"] <= res["err_bound"]
                     and res["residual_kernel"] <= res["residual_bound"])
    return res


def theta0(dtype: torch.dtype, device: torch.device | str) -> Tensor:
    """log10 (lx, ly, sig) of the measured model."""
    return torch.log10(torch.tensor([*P0, SIG0], dtype=dtype,
                                    device=device))


def nll_value_and_grad_autodiff(theta: Tensor, sig2n: Tensor, X: Tensor,
                                z: Tensor):
    """(value, grad) of theta -> nll(10**theta) by autograd through the
    Cholesky: the covariance through ``BuildK`` (the build kernel, and the
    general contraction kernel as its backward, on the card) at the fixed
    base sig, scaled by ``hyp[-1] / sig`` (K is linear in sig)."""
    from sympgpr_tpu_torch.ops import cuda_cov

    theta = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        hyp = 10.0 ** theta
        sig = torch.tensor(SIG0, dtype=X.dtype, device=X.device)
        K = cuda_cov.build_K_cuda(PER_SE, X, X, hyp[:-1], sig) \
            * (hyp[-1] / sig)
        Ky = K + sig2n * torch.eye(K.shape[0], dtype=K.dtype,
                                   device=K.device)
        L, _ = torch.linalg.cholesky_ex(Ky)
        alpha = torch.cholesky_solve(z[:, None], L)[:, 0]
        val = 0.5 * z @ alpha + torch.sum(torch.log(torch.diagonal(L)))
        (g,) = torch.autograd.grad(val, theta)
    return val.detach(), g


def check_gradients(N: int, sig2n: float = 1e-2, *,
                    device: torch.device | str = "cuda") -> dict:
    """The float32 closed-form and autodiff gradients at the measured
    model's theta, each against the closed-form gradient of float64
    copies of the same X and z, and against each other (relative L2 to
    the float64 gradient's norm).  Passes when each lies within
    ``GRAD_RTOL`` of float64 and the two within ``GRAD_RTOL_PATHS`` of
    each other."""
    from sympgpr_tpu_torch.gp.likelihood import nll_value_and_grad_theta

    X, z = synthetic_training_set(N, torch.float32, device=device)
    th = theta0(torch.float32, device)
    s2n = torch.tensor(sig2n, dtype=torch.float32, device=device)
    _, g_cf = nll_value_and_grad_theta(PER_SE, th, s2n, X, z)
    _, g_ad = nll_value_and_grad_autodiff(th, s2n, X, z)
    _, g64 = nll_value_and_grad_theta(PER_SE, th.double(), s2n.double(),
                                      X.double(), z.double())
    g_cf, g_ad, g64 = (g.double().cpu() for g in (g_cf, g_ad, g64))

    def rel(g, ref):
        return float((g - ref).norm() / g64.norm())

    e_cf, e_ad, e_paths = rel(g_cf, g64), rel(g_ad, g64), rel(g_cf, g_ad)
    return {"N": N, "sig2n": sig2n, "device": str(X.device),
            "grad_f64": g64.tolist(), "grad_closed_form": g_cf.tolist(),
            "grad_autodiff": g_ad.tolist(), "err_closed_form": e_cf,
            "err_autodiff": e_ad, "err_between_paths": e_paths,
            "tol": GRAD_RTOL, "tol_between_paths": GRAD_RTOL_PATHS,
            "ok": (e_cf <= GRAD_RTOL and e_ad <= GRAD_RTOL
                   and e_paths <= GRAD_RTOL_PATHS)}


def deployment_instance(theta: Tensor, X: Tensor, z: Tensor, s2n: Tensor):
    """``measure``'s deployment rollout: (pm, q0, p0) for the model at
    log10 hyperparameters ``theta`` (alpha solved through the Cholesky of
    Ky), packed without an aux model with q on the circle of 2 pi, and
    ``ROLLOUT_B`` initial conditions from ``np.random.default_rng(1)``, in
    the dtype and on the device of X."""
    from sympgpr_tpu_torch.gp.model import SympGP
    from sympgpr_tpu_torch.ops import cuda_cov

    hyp = 10.0 ** theta
    Ky = cuda_cov.build_Ky(PER_SE.name, X, hyp[:-1], hyp[-1], s2n)
    L, _ = torch.linalg.cholesky_ex(Ky)
    alpha = torch.cholesky_solve(z[:, None], L)[:, 0]
    del Ky, L
    sgp = SympGP.from_alpha(PER_SE, hyp[:-1], hyp[-1], s2n, X, z, alpha)
    pm = cuda_step.pack_models(sgp, None, mod_q=2.0 * math.pi,
                               dtype=X.dtype)
    rng = np.random.default_rng(1)
    q0 = torch.as_tensor(rng.uniform(0, 2 * np.pi, ROLLOUT_B),
                         dtype=X.dtype, device=X.device)
    p0 = torch.as_tensor(rng.uniform(-1, 1, ROLLOUT_B), dtype=X.dtype,
                         device=X.device)
    return pm, q0, p0


def measure(N: int = 4096, reps: int = 8, dtype: torch.dtype = torch.float32,
            sig2n: float = 1e-2, train_steps: int = 10, *,
            device: torch.device | str = "cuda") -> dict:
    """Times of the large-N pipeline's stages on ``device``, in seconds.

    Each stage is ``profiling.best_ms`` over ``reps`` calls back to back
    (the two training steps and the stages timed only on the card over
    ``max(2, reps // 2)``), best of 3 after a warm-up.  The keys are the
    JAX package's: on the CPU exactly its CPU set; on the card also
    ``triinv_*``, ``syrk_*`` and the deployment rollout's ``rollout_*``
    (4096 orbits over 256 steps through the rollout kernel at the trained
    hyperparameters, ``rollout_theta``; ``deployment_instance`` rebuilds
    it), and ``launches``: each stage's kernel launches by
    kernel (``profiling.launch_counts``).  ``adam_compile_s`` keeps the
    JAX name: the first Adam run's time less the second's, which in
    PyTorch is first-call overhead (allocator growth, cuBLAS and cuSOLVER
    handles, loading the kernels' libraries), not compilation.  The TPU
    peak probes and the keys that divide by a TPU peak are not ported.
    """
    from sympgpr_tpu_torch.gp import train
    from sympgpr_tpu_torch.gp.likelihood import nll_value_and_grad_theta
    from sympgpr_tpu_torch.ops import cuda_cov

    device = torch.device(device)
    on_card = device.type == "cuda"
    X, z = synthetic_training_set(N, dtype, device=device)
    p0 = torch.tensor(P0, dtype=dtype, device=device)
    sig = torch.tensor(SIG0, dtype=dtype, device=device)
    s2n = torch.tensor(sig2n, dtype=dtype, device=device)
    n = 2 * N
    half = max(2, reps // 2)
    launches: dict[str, dict[str, int]] = {}

    @contextlib.contextmanager
    def counting(stage: str):
        """Record the kernel launches of the block under ``stage``."""
        before = profiling.launch_counts()
        yield
        after = profiling.launch_counts()
        launches[stage] = {k: after[k] - before[k] for k in after}

    def timed(stage: str, fn, calls: int) -> float:
        """Seconds a call of ``fn``."""
        with counting(stage):
            return profiling.best_ms(fn, calls=calls, device=device) * 1e-3

    def build_Ky(params, s):
        return cuda_cov.build_Ky(PER_SE.name, X, params, s, s2n)

    def nll_eval():
        L, _ = torch.linalg.cholesky_ex(build_Ky(p0, sig))
        alpha = torch.cholesky_solve(z[:, None], L)[:, 0]
        return 0.5 * z @ alpha + torch.sum(torch.log(torch.diagonal(L)))

    th0 = theta0(dtype, device)
    t_build = timed("build", lambda: build_Ky(p0, sig), reps)
    Ky0 = build_Ky(p0, sig)
    t_chol = timed("cholesky", lambda: torch.linalg.cholesky_ex(Ky0), reps)
    t_nll = timed("nll_eval", nll_eval, reps)
    t_step = timed("train_step", lambda: nll_value_and_grad_theta(
        PER_SE, th0, s2n, X, z), half)
    t_step_auto = timed("train_step_autodiff",
                        lambda: nll_value_and_grad_autodiff(th0, s2n, X, z),
                        half)

    # Adam, run twice: the first run carries the first-call overhead
    with counting("adam"):
        t0 = time.perf_counter()
        theta, hist = train._adam(PER_SE, X, z, th0, s2n, train_steps,
                                  ADAM_LR)
        hist = hist.cpu().numpy()  # the fetch synchronises
        t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    float(train._adam(PER_SE, X, z, th0, s2n, train_steps, ADAM_LR)[1][-1])
    t_adam = time.perf_counter() - t0
    nll_first, nll_last = float(hist[0]), float(hist[-1])

    card: dict = {}
    if on_card:
        from sympgpr_tpu_torch.linalg.triangular import tri_inv_blocked
        from sympgpr_tpu_torch.ops.cuda_syrk import syrk_lower

        L0, _ = torch.linalg.cholesky_ex(Ky0)
        t_ti = timed("triinv", lambda: tri_inv_blocked(L0), half)
        W0 = tri_inv_blocked(L0).contiguous()
        t_sy = timed("syrk", lambda: syrk_lower(W0), half)
        del L0, W0
        flops = 2 * n**3 / 3.0
        card = {
            "triinv_s": t_ti,
            "triinv_tflops": flops / t_ti / 1e12,
            "syrk_s": t_sy,
            "syrk_tflops": flops / t_sy / 1e12,
            "triinv_syrk_tflops": 2 * flops / (t_ti + t_sy) / 1e12,
        }

        pm, q0, p0r = deployment_instance(theta, X, z, s2n)

        def roll():
            return cuda_step.rollout_in_kernel(pm, q0, p0r, ROLLOUT_NM,
                                               iters=ROLLOUT_ITERS)

        with counting("rollout"):
            t0 = time.perf_counter()
            _, P = roll()
            torch.cuda.synchronize(device)
            t_roll_first = time.perf_counter() - t0
            dt = profiling.best_ms(roll, warmup=False, device=device) * 1e-3
        steps = (ROLLOUT_NM - 1) * ROLLOUT_B
        card.update({
            "rollout_B": ROLLOUT_B,
            "rollout_nm": ROLLOUT_NM,
            "rollout_compile_s": t_roll_first - dt,
            "rollout_run_s": dt,
            "rollout_steps_per_s": steps / dt,
            "rollout_pair_gsteps_per_s": steps * pm.ns / dt / 1e9,
            "rollout_finite_frac": float(torch.isfinite(P[-1]).double()
                                         .mean()),
            "rollout_theta": theta.tolist(),
            "launches": launches,
        })

    entries = float(n) * n
    chol_flops = n**3 / 3.0
    return {
        "N": N,
        "n": n,
        "dtype": str(dtype).removeprefix("torch."),
        "device": (torch.cuda.get_device_name(device) if on_card
                   else str(device)),
        "build_s": t_build,
        "build_entries_per_s": entries / t_build,
        "cholesky_s": t_chol,
        "cholesky_gflops": chol_flops / t_chol / 1e9,
        "build_plus_chol_gflops": chol_flops / (t_build + t_chol) / 1e9,
        "nll_eval_s": t_nll,
        "train_step_s": t_step,
        "train_step_autodiff_s": t_step_auto,
        "train_step_over_eval": t_step / t_nll,
        "adam_compile_s": t_first - t_adam,
        "adam_10step_s": t_adam,
        "nll_first": nll_first,
        "nll_last": nll_last,
        "nll_decreased": bool(nll_last < nll_first),
        **card,
    }


# the JAX package's run_distributed settings
DIST_X0 = (-0.4, -0.4, 0.3)


def run_distributed(N: int = 1024, steps: int = 20, block: int = 64,
                    lr: float = 5e-2, sig2n: float = 1e-2,
                    save: str | None = None, parity_limit: int = 2048, *,
                    device: torch.device | str = "cuda") -> dict:
    """Distributed large-N training end to end: block-cyclic build ->
    distributed Cholesky -> Adam on forward-mode gradients -> distributed
    alpha -> checkpoint -> parity against the dense solve at N <=
    ``parity_limit``.  Every rank calls it and returns the same summary.

    Runs on the process group that is up (under ``python -m
    torch.distributed.run``, the launcher's), else starts a world of one
    rank on ``device`` (``distributed/init.py::initialize``; NCCL on the
    card, gloo on the CPU) and ends it after.  The mesh is every rank on
    one ``kp`` axis.  float64 on the CPU, float32 on the card, as the JAX
    package.  The summary has the JAX keys; ``mesh`` names the backend.
    ``t_train_s`` is the whole fit (the Adam loop and the distributed
    alpha); the fit runs once, so ``t_train_warm_s`` is the Adam loop less
    its first step, which carries the process's one-off costs (cuBLAS and
    cuSOLVER handles, the allocator's growth, NCCL's first collective).
    The checkpoint is written by rank 0 through ``gp/model.py::
    save_models`` and read back on every rank.
    """
    import os
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from sympgpr_tpu_torch.distributed import init as dinit
    from sympgpr_tpu_torch.distributed.large import fit_large
    from sympgpr_tpu_torch.gp.covariance import build_K_fast
    from sympgpr_tpu_torch.gp.model import load_models, save_models

    started = not dist.is_initialized()
    device = dinit.initialize(device)
    try:
        D = dist.get_world_size()
        mesh = init_device_mesh(device.type, (D,), mesh_dim_names=("kp",))
        dtype = torch.float64 if device.type == "cpu" else torch.float32
        X, z = synthetic_training_set(N, dtype, device=device)
        timings: dict = {}
        t0 = time.perf_counter()
        model, hist = fit_large(PER_SE, mesh, X, z, sig2n, DIST_X0,
                                steps=steps, lr=lr, block=block,
                                timings=timings)
        t_train = time.perf_counter() - t0

        path = [save]
        if save is None and dist.get_rank() == 0:
            path = [os.path.join(tempfile.mkdtemp(), "large_n_fit.npz")]
        dist.broadcast_object_list(path, src=0)  # rank 0's path
        path = path[0]
        if dist.get_rank() == 0:
            save_models(path, model)
        dist.barrier()
        model2, _, _ = load_models(path, device)
        assert torch.equal(model2.alpha, model.alpha)

        out = {
            "N": N,
            "devices": D,
            "mesh": dist.get_backend(),
            "dtype": str(dtype).removeprefix("torch."),
            "steps": steps,
            "nll_first": float(hist[0]),
            "nll_last": float(hist[-1]),
            "nll_decreased": bool(hist[-1] < hist[0]),
            "hyp": model.params.tolist(),
            "sig": float(model.sig),
            "t_train_s": t_train,
            "t_train_warm_s": timings["train_warm_s"],
            "per_device_K_bytes": (2 * N) ** 2 // D * X.element_size(),
            "checkpoint": path,
        }
        if N <= parity_limit:
            # dense parity: the same hyperparameters, a dense solve
            K = build_K_fast(PER_SE, X, X, model.params, model.sig)
            Ky = K + model.sig2n * torch.eye(2 * N, dtype=dtype,
                                             device=device)
            a_dense = torch.linalg.solve(Ky, z)
            scale = float(a_dense.abs().max())
            out["alpha_vs_dense_rel"] = float(
                (model.alpha - a_dense).abs().max()) / scale
            out["train_mse"] = float(((K @ model.alpha - z) ** 2).mean())
        return out
    finally:
        if started:
            dinit.shutdown()
