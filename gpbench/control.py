"""The controls: each cell's reference put in the program's place and
computed in the nearest precision below the configuration's, run through
the cell's own set-up, window and check.  A control has to come out as not
correct; its compared numbers set the upper readings of the limits.  Each
call into the program has its control, found by the call's name.

    python -m gpbench.control --workload <cell> --seeds <n> [<n> ...] --seconds <s>

Runs on the card (one line of JSON a seed: the checks and their limits);
the benchmark's own runs never run it.  The controls by call:

* ``deploy`` and ``rollout`` (float32): the reference map in bfloat16
  (alpha solved in float64, as the deployment, then rounded), the
  configuration's Newton iterations, loss check and wraps;
* ``fit_large`` (float32 with IEEE products): the reference Adam with
  TF32 products (``allow_tf32``), its alpha and training error likewise.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from gpbench import harness, program
from gpbench.reference import gp as ref_gp
from gpbench.rollouts import reference_lost, reference_model

BF16 = torch.bfloat16


def _deploy(config, d):
    """The reference's bfloat16 model, with the loss rule that its rollout
    applies."""
    m = reference_model(config, d)
    m = {k: (v.to(BF16) if torch.is_tensor(v) else v) for k, v in m.items()}
    return dict(m, lost=reference_lost(config))


def _rollout(pm, q0, p0, nm, iters, loss_check):
    Q, P = ref_gp.rollout(pm, q0.to(BF16), p0.to(BF16), nm, iters,
                          pm["lost"] if loss_check else None)
    return Q.float().contiguous(), P.float().contiguous()


@contextlib.contextmanager
def tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fit_large(config, X, z):
    f = config["fit"]
    kern = ref_gp.kernel(config["kernel"])
    with tf32():
        theta, hist = ref_gp.adam(kern, X, z, f["theta0"], config["sig2n"],
                                  f["steps"], f["lr"])
        lx, ly, sig = (10.0 ** theta).tolist()
        K = ref_gp.cov(kern, X, X, lx, ly, sig)
        alpha = ref_gp.solve(K, config["sig2n"], z)
        mse = float(torch.mean((K @ alpha - z) ** 2))
    return dict(theta=theta, hist=hist.cpu().numpy(), alpha=alpha,
                train_mse=mse, sig2n=config["sig2n"], escalations=0)


# the control of each call into the program, by the call's name
CONTROLS = {"deploy": _deploy, "rollout": _rollout, "fit_large": _fit_large}


def control_program(cell) -> dict:
    """The controls of the calls that the cell's driver makes: those
    above, or ``control`` of the call's own file
    (``gpbench/calls/<name>.py``)."""
    return {name: CONTROLS[name] if name in CONTROLS
            else program.call_file(name).control
            for name in harness.driver_class(cell.driver).calls}


def main(argv: list[str] | None = None) -> int:
    from gpbench import run as runner

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpbench.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        res = runner.run(args.workload, seed, args.seconds, False, dev,
                         program=control_program(cell),
                         t0=runner.time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": harness.limits_line(res["checks"])},
                         default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
