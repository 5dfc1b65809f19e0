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
the Cholesky, the covariance build, the contraction and one fit step
(``nll_value_and_grad_theta``), and the fit's 60-step Adam loop once
(``gp/train.py::_adam`` from (0.5, 2.5, 2.0), lr 5e-2, as
``tokamak_large``; one run after a warm-up run, ms per step).  The syrk's
error against float64 is
printed beside its TFLOP/s on n^3 / 3 flop (the lower triangle of W^T W
over a triangular W), and the ptxas report (registers, spills) of the
kernels of ``tri_matmul.cu`` and ``cov_blocks.cu``.  Prints one JSON line
per checkout, then the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HYP = (0.541, 1.391, 26.55)
N_TRAIN = 4096
SIG2N = 1e-2
ADAM_STEPS = 60


def _time(fn, reps: int) -> tuple[float, float]:
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
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


def run_one(tree: str, reps: int) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from sympgpr_tpu_torch.gp import train
    from sympgpr_tpu_torch.gp.likelihood import nll_value_and_grad_theta
    from sympgpr_tpu_torch.kernels import PER_SE
    from sympgpr_tpu_torch.linalg import triangular
    from sympgpr_tpu_torch.ops import _build, cuda_cov, cuda_syrk
    from sympgpr_tpu_torch.systems import tokamak as tk

    dev = torch.device("cuda", 0)
    data = tk.training_data(tk.TokamakConfig(N=N_TRAIN), dev)
    q, p = data["q"][:, 0], data["p"][:, 0]
    Q, P = data["Q"][:, 0], data["P"][:, 0]
    X = torch.stack([q, P], 1).float()
    z = torch.cat([p - P, Q - q]).float()
    params = torch.tensor(HYP[:2], dtype=torch.float32, device=dev)
    sig = torch.tensor(HYP[2], dtype=torch.float32, device=dev)
    s2n = torch.tensor(SIG2N, dtype=torch.float32, device=dev)

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

    row = dict(tree=tree, n=n,
               syrk_rel_err=float((S.double() - S64).abs().max()) / scale,
               syrk_symmetric=bool(torch.equal(S, S.T)),
               syrk_f64_rel_err=float(
                   (cuda_syrk.syrk_lower(W64) - S64).abs().max()) / scale)
    del S64
    timed = {
        "syrk": lambda: cuda_syrk.syrk_lower(W),
        "syrk_f64": lambda: cuda_syrk.syrk_lower(W64),
        "cublas_f32_WtW": lambda: torch.matmul(W.T, W),
        "cublas_f64_WtW": lambda: torch.matmul(W64.T, W64),
        "tri_inv": lambda: triangular.tri_inv_blocked(L),
        "cholesky": lambda: torch.linalg.cholesky_ex(Ky),
        "build": lambda: cuda_cov.build_K_blocks("per_se", X, X, params,
                                                 sig),
        "contraction": lambda: cuda_cov.cov_param_grads("per_se", X, X,
                                                        params, sig, Kbar),
        "fit_step": lambda: nll_value_and_grad_theta(PER_SE, theta, s2n, X,
                                                     z),
    }
    for name, fn in timed.items():
        row[name + "_ms"], row[name + "_median_ms"] = _time(fn, reps)
    theta0 = torch.log10(torch.tensor((0.5, 2.5, 2.0), device=dev))
    row["adam_step_ms"] = _time(lambda: train._adam(
        PER_SE, X, z, theta0, s2n, ADAM_STEPS, 5e-2), 1)[0] / ADAM_STEPS
    flop = n ** 3 / 3
    row["syrk_tflops"] = flop / (row["syrk_ms"] * 1e9)
    row["syrk_f64_tflops"] = flop / (row["syrk_f64_ms"] * 1e9)
    row["ptxas"] = {name: _ptxas(_build.library_path(name).with_suffix(
        ".log")) for name in ("tri_matmul", "cov_blocks")}
    print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if args.one:
        run_one(args.one, args.reps)
        return
    for tree in args.trees:
        subprocess.run([sys.executable, __file__, "--one", tree, "--reps",
                        str(args.reps)], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
