"""Command-line interface of the PyTorch port.

  python -m sympgpr_tpu_torch list
  python -m sympgpr_tpu_torch run tokamak --nm 1000 --device cuda
  python -m sympgpr_tpu_torch run tokamak_kernel --device cuda
  python -m sympgpr_tpu_torch run tokamak_split --device cuda
  python -m sympgpr_tpu_torch run tokamak_split_kernel --device cuda
  python -m sympgpr_tpu_torch run tokamak_large --n 4096 --steps 40 --device cuda

``--device`` defaults to ``cuda`` and fails when no GPU is present; pass
``--device cpu`` to run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# the Split tokamak's configuration (the JAX package's ``tokamak_split``)
SPLIT = dict(N=70, nphmap=4, nph=100, r_scale=0.38, qminmap=0.16,
             qmaxmap=0.31)
WORKLOADS = {
    # name -> (backend of workloads.tokamak.run, TokamakConfig fields, nm,
    # optimizer), or None: its own run function
    "tokamak": ("generic", {}, 1000, "lbfgs"),
    "tokamak_kernel": ("kernel", {}, 1000, "lbfgs"),
    # the Split tokamak optimizes with CMA-ES
    "tokamak_split": ("generic", SPLIT, 4000, "cmaes"),
    "tokamak_split_kernel": ("kernel", SPLIT, 4000, "cmaes"),
    "tokamak_large": None,
}


def _summarize(out: dict) -> dict:
    """The keys ``sympgpr_tpu.__main__._summarize`` prints for tokamak."""
    s = {k: out[k] for k in ("training_error", "t_train", "t_apply",
                             "n_lost", "optimizer")}
    for k in ("Eosc", "gd"):
        s[f"mean_{k}"] = float(np.nanmean(out[k]))
    return s


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return device


def cmd_run(args):
    if args.workload not in WORKLOADS:
        sys.exit(f"unknown workload {args.workload!r}; "
                 f"available: {sorted(WORKLOADS)}")
    device = _device(args.device)
    if args.workload == "tokamak_large":
        from sympgpr_tpu_torch.workloads import tokamak_large

        out = tokamak_large.run(
            n_train=args.n or 4096, nm=args.nm or 1000,
            steps=args.steps or 40,
            **({"sig2n": args.sig2n} if args.sig2n else {}), device=device)
        out.pop("models")
        print(json.dumps(out))
        return
    from sympgpr_tpu_torch.systems import tokamak as tk
    from sympgpr_tpu_torch.systems.tokamak import TokamakConfig
    from sympgpr_tpu_torch.workloads import tokamak

    backend, fields, nm, optimizer = WORKLOADS[args.workload]
    cfg = TokamakConfig(**fields, nm=args.nm or nm)
    out = tokamak.run(cfg, optimizer=args.optimizer or optimizer,
                      backend=backend, with_reference=args.with_reference,
                      device=device)
    if "gd" not in out:
        (r0, th0), _ = tk.test_initial_conditions(cfg)
        out.update(tokamak.one_turn_gd(cfg, out["traj"], r0, th0, device))
    print(json.dumps(_summarize(out), default=str))


def cmd_list(args):
    for name in sorted(WORKLOADS):
        print(name)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sympgpr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="run a workload")
    p_run.add_argument("workload")
    p_run.add_argument("--nm", type=int, default=None,
                       help="number of map applications")
    p_run.add_argument("--optimizer", default=None, choices=("lbfgs", "cmaes"),
                       help="hyperparameter optimizer")
    p_run.add_argument("--n", type=int, default=None,
                       help="training-set size (tokamak_large)")
    p_run.add_argument("--steps", type=int, default=None,
                       help="optimizer steps (tokamak_large)")
    p_run.add_argument("--sig2n", type=float, default=None,
                       help="fit jitter of tokamak_large (escalates x10 if "
                            "the float32 Cholesky rejects it)")
    p_run.add_argument("--device", default="cuda",
                       help="torch device (default cuda)")
    p_run.add_argument("--with-reference", action="store_true",
                       help="also integrate the nm-turn plotting reference "
                            "(minutes in eager mode); gd always comes from "
                            "the one-turn reference")
    p_run.set_defaults(fn=cmd_run)

    p_list = sub.add_parser("list", help="list workloads")
    p_list.set_defaults(fn=cmd_list)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
