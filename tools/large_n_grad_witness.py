#!/usr/bin/env python3
"""How far the large-N float32 NLL gradients lie from float64, and where
the error comes from: ``workloads/large_n.py::check_gradients`` (the
closed-form and the autodiff gradient in float32 at the measured model's
theta, each against the float64 closed-form gradient of the same X and z)
over a list of noise variances sig2n, on one device.

    python tools/large_n_grad_witness.py [--n 4096] [--device cuda]
        [--sig2n 1e-1 1e-2] [--variant kernels plain_build cpu_cholesky]
        [--build-error] [--out FILE]

On ``--device cpu`` the kernels' plain PyTorch versions compute both
float32 gradients.  On the card, ``--variant`` swaps one float32 stage of
the path for another implementation, to find the stage that sets the
error: ``kernels`` (the path as it runs), ``plain_build`` (the build's
plain version on the card's tensors in place of the build kernel; the
contraction kernels stay) and ``cpu_cholesky`` (the float32 Cholesky
factorizations by LAPACK on the host in place of cuSOLVER).  An error
that grows as sig2n shrinks (K's condition number grows as 1 / sig2n) is
rounding amplified by the conditioning.  ``--build-error`` adds one line
per sig2n with the float32 Ky of the build kernel and of the plain
version against the float64 plain Ky (relative Frobenius norm, largest
entry difference over the largest entry) and each float32 Cholesky's
backward error ||L L^T - Ky|| / ||Ky||.  One JSON line per result, with
its seconds; ``--out`` appends them to a file too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sympgpr_tpu_torch.kernels import PER_SE  # noqa: E402
from sympgpr_tpu_torch.ops import cuda_cov  # noqa: E402
from sympgpr_tpu_torch.workloads import large_n  # noqa: E402


def _cholesky_on_host(A, *args, **kw):
    """``torch.linalg.cholesky_ex`` of a float32 tensor by LAPACK on the
    host, its results moved back (autograd follows the copies)."""
    if A.dtype != torch.float32 or A.device.type == "cpu":
        return _CHOLESKY_EX(A, *args, **kw)
    L, info = _CHOLESKY_EX(A.cpu(), *args, **kw)
    return L.to(A.device), info.to(A.device)


_CHOLESKY_EX = torch.linalg.cholesky_ex


@contextlib.contextmanager
def variant(name: str):
    """The float32 path with one stage swapped (see the module doc)."""
    saved = (cuda_cov.build_Ky, cuda_cov.build_K_blocks,
             torch.linalg.cholesky_ex)
    if name == "plain_build":
        cuda_cov.build_Ky = cuda_cov.build_Ky_reference
        cuda_cov.build_K_blocks = cuda_cov.build_K_blocks_reference
    elif name == "cpu_cholesky":
        torch.linalg.cholesky_ex = _cholesky_on_host
    elif name != "kernels":
        raise ValueError(f"unknown variant {name!r}")
    try:
        yield
    finally:
        (cuda_cov.build_Ky, cuda_cov.build_K_blocks,
         torch.linalg.cholesky_ex) = saved


def build_error(N: int, sig2n: float, device) -> dict:
    """The float32 Ky of the build kernel and of the plain version against
    the float64 plain Ky, and each float32 Cholesky's backward error."""
    X, _ = large_n.synthetic_training_set(N, torch.float32, device=device)
    hyp = 10.0 ** large_n.theta0(torch.float32, device)
    Ky64 = cuda_cov.build_Ky_reference(PER_SE.name, X.double(),
                                       hyp[:-1].double(), hyp[-1].double(),
                                       sig2n)
    out = {"N": N, "sig2n": sig2n, "device": str(X.device)}
    for name, fn in (("kernel", cuda_cov.build_Ky),
                     ("plain", cuda_cov.build_Ky_reference)):
        Ky = fn(PER_SE.name, X, hyp[:-1], hyp[-1], sig2n)
        d = Ky.double() - Ky64
        out[f"Ky_{name}_rel_fro"] = float(d.norm() / Ky64.norm())
        out[f"Ky_{name}_rel_max"] = float(d.abs().max() / Ky64.abs().max())
        for where, A in (("card", Ky), ("host", Ky.cpu())):
            L, info = _CHOLESKY_EX(A)
            r = (L.double() @ L.double().T - A.double()).norm() \
                / A.double().norm()
            out[f"chol_{where}_of_Ky_{name}_backward_err"] = float(r)
            out[f"chol_{where}_of_Ky_{name}_info"] = int(info)
        del Ky, d
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096,
                    help="training points N (K is 2N x 2N)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sig2n", type=float, nargs="+", default=[1e-2])
    ap.add_argument("--variant", nargs="+", default=["kernels"],
                    choices=["kernels", "plain_build", "cpu_cholesky"])
    ap.add_argument("--build-error", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    def emit(res: dict, t0: float) -> None:
        res["s"] = time.perf_counter() - t0
        res["threads"] = torch.get_num_threads()
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for s in args.sig2n:
        if args.build_error:
            t0 = time.perf_counter()
            emit(build_error(args.n, s, torch.device(args.device)), t0)
        for v in args.variant:
            t0 = time.perf_counter()
            with variant(v):
                res = large_n.check_gradients(args.n, s, device=args.device)
            emit(dict(res, variant=v), t0)


if __name__ == "__main__":
    main()
