#!/usr/bin/env python3
"""Time the PyTorch port's large-N fit step and its kernels for one or more
checkouts of this repository in turns, on one CUDA card.

    python tools/fit_step_ab.py --trees OLD . . OLD [--reps 5]

Each entry of ``--trees`` is the root of a checkout; each runs in its own
process, with its own ``sympgpr_tpu_torch`` package and kernel build, on
the same inputs: the tokamak section crossings of ``systems/tokamak.py``
at N = 4096 (``tokamak_large``'s size, K is 8192 x 8192), float32, per_se
at the N = 4096 fit's hyperparameters (lx, ly, sig = 0.541, 1.391, 26.55)
and sig2n = 1e-2.  From them: K (the covariance build kernel), its
Cholesky L, W = L^{-1} (``tri_inv_blocked``), S = W^T W (the syrk kernel)
and Kbar = S / 2 - alpha alpha^T / 2 (the contraction's input).

Timed with CUDA events, best and median of ``--reps`` after one warm-up:
the syrk in float32 and on a float64 copy of W, beside cuBLAS's float32
``W.T @ W`` (float32 accumulation, another function) and DGEMM on the
float64 copy (the same function: float64 products and sums); ``tri_inv``,
the Cholesky, the alpha solve (``cholesky_solve``) and, where the
checkout has it, alpha as S z by the product kernel (``alpha_matvec``),
each alpha's error against a float64 solve with the same factor, the
covariance build (general mode on
X, X; and ``build_Ky``, the symmetric mode writing Ky, where the checkout
has it), the contraction (general entry on Kbar; and the fused
``cov_param_grads_sym`` on S and alpha where the checkout has it), the
plain passes around them in the fit step (``eye_add``: K + sig2n I;
``where_L``: the NaN-masked copy of the factor; ``kbar``: S / 2 -
alpha alpha^T / 2; ``zeros_like_W``: the buffer ``tri_inv_blocked``
clears; ``nll_terms``: the value from z, alpha and the factor's diagonal),
one fit step (``nll_value_and_grad_theta``) and what of it the timed parts
of the checkout's own path leave (``unexplained_ms``), and the fit's
60-step Adam loop once (``gp/train.py::_adam`` from (0.5, 2.5, 2.0),
lr 5e-2, as ``tokamak_large``; one run after a warm-up run, ms per step),
beside the host's time to issue it (``adam_host_ms``), the profiler's
sum of the card's kernel time over 10 steps (``adam_device_busy_ms``) and
the functions of most host time under ``cProfile`` (``adam_host_profile``).
A single call's time holds its wrapper's host work where the card waits
for it, so the covariance kernels are also timed over 20 calls back to
back (``*_b2b_ms``) and by the profiler's device time of their kernels
(``*_kernel_ms``).

The first fit of a process is timed apart, on the host clock with a
synchronisation after each part: right after the data, each part of the
checkout's fit step is called once cold and once warm (``first_s`` and
``second_s``: first allocations, library handles, lazy module loads); a
second process per checkout (``--first``) times its first 60-step Adam
loop and a second one (``adam_first_s``, ``adam_second_s``).

The syrk's error against float64 is printed beside its TFLOP/s on n^3 / 3
flop (the lower triangle of W^T W over a triangular W), the ptxas report
(registers, spills) of the kernels of ``tri_matmul.cu`` and
``cov_blocks.cu``, and each covariance kernel's SASS instruction counts
(``cuobjdump -sass``: all, and those of the floating-point pipes).  Prints one JSON line per checkout and process
(``package``: the directory of the ``sympgpr_tpu_torch`` it timed), then
the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HYP = (0.541, 1.391, 26.55)
N_TRAIN = 4096
SIG2N = 1e-2
ADAM_STEPS = 60


def _chip_smoke():
    """The measurement helpers (SASS counts, the profiler's device time)
    of this tool's own checkout's ``chip_smoke.py``, whichever checkout it
    times.  Loaded by path once the timed checkout is first on
    ``sys.path``, so that the ``sympgpr_tpu_torch`` it imports, and with
    it every part timed here, is the timed checkout's package."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _time(fn, reps: int, calls: int = 1) -> tuple[float, float]:
    """Best and median ms a call over ``reps`` runs of ``calls`` calls
    back to back (so that the host's launch work overlaps the card's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / calls)
    return min(ts), statistics.median(ts)


def _ptxas(log: Path) -> dict:
    """Registers and spill-store bytes, as "R/S", of each kernel in one
    nvcc log, keyed by kernel name and mangled template arguments."""
    out, kernel, prev = {}, None, ""
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"\d([a-z_]+_kernel)I(\w*?)EEv", ln)
            kernel = f"{m[1]}<{m[2]}>" if m else ln.split("'")[1]
        elif kernel and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln)[1]
            spill = re.search(r"(\d+) bytes spill stores", prev)[1]
            out[kernel] = f"{regs}/{spill}"
        prev = ln
    return out


def _sass(library: Path, chip_smoke) -> dict:
    """``chip_smoke.sass_counts`` of each covariance kernel instance in a
    built library, keyed by its mangled template arguments, as "all/fp"."""
    out = {}
    for head, n in chip_smoke.sass_counts(library).items():
        m = re.search(r"(cov_\w+?_kernel)I(\w+?)E(?:EE|Ev)", head)
        if m:
            out[f"{m[1]}<{m[2]}>"] = f"{n['total']}/{n['fp']}"
    return out


def _host_profile(fn, steps: int, top: int = 15) -> list:
    """Where the host's time goes in ``fn`` (``steps`` steps): the
    functions of most own time under ``cProfile``, as [name, ms a step,
    calls a step], and the kernel launches a step from the profiler."""
    import cProfile
    import pstats

    import torch

    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    torch.cuda.synchronize()
    st = pstats.Stats(prof).stats
    rows = sorted(((f"{k[0].rsplit('/', 1)[-1]}:{k[1]}:{k[2]}",
                    v[2] * 1e3 / steps, v[1] / steps)
                   for k, v in st.items()), key=lambda r: -r[1])
    return [[n, round(ms, 4), c] for n, ms, c in rows[:top]]


def _data(dev):
    import torch

    from sympgpr_tpu_torch.systems import tokamak as tk

    data = tk.training_data(tk.TokamakConfig(N=N_TRAIN), dev)
    q, p = data["q"][:, 0], data["p"][:, 0]
    Q, P = data["Q"][:, 0], data["P"][:, 0]
    X = torch.stack([q, P], 1).float().contiguous()
    z = torch.cat([p - P, Q - q]).float()
    return X, z


def _step_parts(X, z, params, sig, s2n) -> dict:
    """The checkout's fit step, part by part, as closures in order (the
    fused entries where the checkout has them)."""
    import torch

    from sympgpr_tpu_torch import ops
    from sympgpr_tpu_torch.linalg import triangular
    from sympgpr_tpu_torch.ops import cuda_cov, cuda_syrk

    st, n = {}, 2 * X.shape[0]
    fused = hasattr(cuda_cov, "build_Ky")
    # alpha = S z after the syrk where the checkout has the product kernel
    matvec = _matvec_module(ops)
    parts = {}
    if fused:
        parts["build_Ky"] = lambda: st.update(Ky=cuda_cov.build_Ky(
            "per_se", X, params, sig, s2n))
    else:
        parts["build"] = lambda: st.update(K=cuda_cov.build_K_blocks(
            "per_se", X, X, params, sig))
        parts["eye_add"] = lambda: st.update(Ky=st["K"] + s2n * torch.eye(
            n, dtype=X.dtype, device=X.device))
    parts["cholesky"] = lambda: st.update(zip(
        ("L", "info"), torch.linalg.cholesky_ex(st["Ky"])))
    if not fused:
        parts["where_L"] = lambda: st.update(L=torch.where(
            st["info"] == 0, st["L"], math.nan))
    if matvec is None:
        parts["alpha_solve"] = lambda: st.update(
            alpha=torch.cholesky_solve(z[:, None], st["L"])[:, 0])
        parts["nll_terms"] = lambda: 0.5 * z @ st["alpha"] + torch.sum(
            torch.log(torch.diagonal(st["L"])))
    parts["tri_inv"] = lambda: st.update(W=triangular.tri_inv_blocked(
        st["L"]).contiguous())
    parts["syrk"] = lambda: st.update(S=cuda_syrk.syrk_lower(st["W"]))
    if matvec is not None:
        parts["alpha_matvec"] = lambda: st.update(alpha=matvec.matvec(
            st["S"], z))
        parts["nll_terms"] = lambda: 0.5 * z @ st["alpha"] + torch.sum(
            torch.log(torch.diagonal(st["L"])))
    if fused:
        parts["contraction_sym"] = lambda: cuda_cov.cov_param_grads_sym(
            "per_se", X, params, sig, st["S"], st["alpha"])
    else:
        parts["kbar"] = lambda: st.update(Kbar=0.5 * st["S"] - 0.5 * torch.outer(
            st["alpha"], st["alpha"]))
        parts["contraction"] = lambda: cuda_cov.cov_param_grads(
            "per_se", X, X, params, sig, st["Kbar"])
    return parts


def _matvec_module(ops):
    """The checkout's ``ops.cuda_matvec``, or None where it has none."""
    import importlib

    try:
        return importlib.import_module(ops.__name__ + ".cuda_matvec")
    except ModuleNotFoundError:
        return None


def _host_s(fn) -> float:
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _inputs(dev):
    import torch

    X, z = _data(dev)
    params = torch.tensor(HYP[:2], dtype=torch.float32, device=dev)
    sig = torch.tensor(HYP[2], dtype=torch.float32, device=dev)
    s2n = torch.tensor(SIG2N, dtype=torch.float32, device=dev)
    return X, z, params, sig, s2n


def run_first(tree: str) -> None:
    """The first 60-step Adam loop of a process, and a second one."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from sympgpr_tpu_torch.gp import train
    from sympgpr_tpu_torch.kernels import PER_SE

    dev = torch.device("cuda", 0)
    X, z, _, _, s2n = _inputs(dev)
    torch.cuda.synchronize()
    theta0 = torch.log10(torch.tensor((0.5, 2.5, 2.0), device=dev))

    def adam():
        return train._adam(PER_SE, X, z, theta0, s2n, ADAM_STEPS, 5e-2)

    row = dict(tree=tree, mode="first", adam_first_s=_host_s(adam),
               adam_second_s=_host_s(adam))
    print(json.dumps(row), flush=True)


def run_one(tree: str, reps: int) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import sympgpr_tpu_torch
    from sympgpr_tpu_torch import ops
    from sympgpr_tpu_torch.gp import train
    from sympgpr_tpu_torch.gp.likelihood import nll_value_and_grad_theta
    from sympgpr_tpu_torch.kernels import PER_SE
    from sympgpr_tpu_torch.linalg import triangular
    from sympgpr_tpu_torch.ops import _build, cuda_cov, cuda_syrk

    chip_smoke = _chip_smoke()
    dev = torch.device("cuda", 0)
    X, z, params, sig, s2n = _inputs(dev)
    torch.cuda.synchronize()
    parts = _step_parts(X, z, params, sig, s2n)
    first = {k: _host_s(fn) for k, fn in parts.items()}
    second = {k: _host_s(fn) for k, fn in parts.items()}

    K = cuda_cov.build_K_blocks("per_se", X, X, params, sig)
    n = K.shape[0]
    Ky = K + SIG2N * torch.eye(n, dtype=K.dtype, device=dev)
    L, info = torch.linalg.cholesky_ex(Ky)
    assert int(info) == 0, "Cholesky failed"
    alpha = torch.cholesky_solve(z[:, None], L)[:, 0]
    W = triangular.tri_inv_blocked(L).contiguous()
    S = cuda_syrk.syrk_lower(W)
    W64 = W.double()
    S64 = W64.T @ W64
    scale = float(S64.abs().max())
    Kbar = 0.5 * S - 0.5 * torch.outer(alpha, alpha)
    theta = torch.log10(torch.cat([params, sig[None]]))
    matvec = _matvec_module(ops)
    # each float32 alpha against a float64 solve with the same factor
    a64 = torch.cholesky_solve(z.double()[:, None], L.double())[:, 0]
    alpha_err = {"alpha_solve_rel_err": alpha}
    if matvec is not None:
        alpha_err["alpha_matvec_rel_err"] = matvec.matvec(S, z)
    alpha_err = {k: float((a.double() - a64).norm() / a64.norm())
                 for k, a in alpha_err.items()}
    del a64

    row = dict(tree=tree, package=str(Path(sympgpr_tpu_torch.__file__)
                                      .parent.resolve()),
               n=n, first_s=first, second_s=second,
               syrk_rel_err=float((S.double() - S64).abs().max()) / scale,
               syrk_symmetric=bool(torch.equal(S, S.T)),
               syrk_f64_rel_err=float(
                   (cuda_syrk.syrk_lower(W64) - S64).abs().max()) / scale,
               **alpha_err)
    del S64
    timed = {
        "syrk": lambda: cuda_syrk.syrk_lower(W),
        "syrk_f64": lambda: cuda_syrk.syrk_lower(W64),
        "cublas_f32_WtW": lambda: torch.matmul(W.T, W),
        "cublas_f64_WtW": lambda: torch.matmul(W64.T, W64),
        "tri_inv": lambda: triangular.tri_inv_blocked(L),
        "cholesky": lambda: torch.linalg.cholesky_ex(Ky),
        "alpha_solve": lambda: torch.cholesky_solve(z[:, None], L),
        "build": lambda: cuda_cov.build_K_blocks("per_se", X, X, params,
                                                 sig),
        "contraction": lambda: cuda_cov.cov_param_grads("per_se", X, X,
                                                        params, sig, Kbar),
        "eye_add": lambda: K + s2n * torch.eye(n, dtype=K.dtype, device=dev),
        "where_L": lambda: torch.where(info == 0, L, math.nan),
        "kbar": lambda: 0.5 * S - 0.5 * torch.outer(alpha, alpha),
        "zeros_like_W": lambda: torch.zeros_like(L),
        "nll_terms": lambda: 0.5 * z @ alpha + torch.sum(
            torch.log(torch.diagonal(L))),
        "fit_step": lambda: nll_value_and_grad_theta(PER_SE, theta, s2n, X,
                                                     z),
    }
    if matvec is not None:
        timed["alpha_matvec"] = lambda: matvec.matvec(S, z)
    if hasattr(cuda_cov, "build_Ky"):
        timed["build_Ky"] = lambda: cuda_cov.build_Ky("per_se", X, params,
                                                      sig, s2n)
        timed["contraction_sym"] = lambda: cuda_cov.cov_param_grads_sym(
            "per_se", X, params, sig, S, alpha)
    for name, fn in timed.items():
        row[name + "_ms"], row[name + "_median_ms"] = _time(fn, reps)
    row["step_path"] = list(parts)
    row["unexplained_ms"] = row["fit_step_ms"] - sum(
        row[k + "_ms"] for k in parts)
    theta0 = torch.log10(torch.tensor((0.5, 2.5, 2.0), device=dev))

    def adam(steps=ADAM_STEPS):
        return train._adam(PER_SE, X, z, theta0, s2n, steps, 5e-2)

    row["adam_step_ms"] = _time(adam, 1)[0] / ADAM_STEPS
    # the host's time to issue the loop (nothing inside waits for the card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adam()
    row["adam_host_ms"] = (time.perf_counter() - t0) * 1e3 / ADAM_STEPS
    torch.cuda.synchronize()
    # last, as the profiler may slow later launches: the covariance kernels
    # alone (20 calls back to back, and the profiler's device time of their
    # kernels: the contraction's two passes) and the card's busy time a step
    for name, pattern in (("build", "cov_fwd"), ("build_Ky", "cov_fwd"),
                          ("contraction", "cov_"),
                          ("contraction_sym", "cov_")):
        if name in timed:
            row[name + "_b2b_ms"] = _time(timed[name], reps, 20)[0]
            row[name + "_kernel_ms"] = chip_smoke.kernel_ms(timed[name],
                                                            pattern)
    busy = chip_smoke.kernel_ms(lambda: adam(10), "", 1)
    row["adam_device_busy_ms"] = busy and busy / 10
    row["adam_host_profile"] = _host_profile(lambda: adam(5), 5)
    flop = n ** 3 / 3
    row["syrk_tflops"] = flop / (row["syrk_ms"] * 1e9)
    row["syrk_f64_tflops"] = flop / (row["syrk_f64_ms"] * 1e9)
    row["ptxas"] = {name: _ptxas(_build.library_path(name).with_suffix(
        ".log")) for name in ("tri_matmul", "cov_blocks")}
    row["sass_instructions"] = _sass(_build.library_path("cov_blocks"),
                                     chip_smoke)
    print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--first", help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-first", action="store_true",
                    help="skip the processes that time the first fit")
    args = ap.parse_args()
    if args.one:
        run_one(args.one, args.reps)
        return
    if args.first:
        run_first(args.first)
        return
    for tree in args.trees:
        subprocess.run([sys.executable, __file__, "--one", tree, "--reps",
                        str(args.reps)], check=True)
    for tree in [] if args.no_first else args.trees:
        subprocess.run([sys.executable, __file__, "--first", tree],
                       check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
