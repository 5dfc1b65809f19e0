#!/usr/bin/env python3
"""Where the time of one sampler evaluation goes on the card: the batched
log-probability and its gradient (``gp/hmc.py::value_and_grad`` over
``nll_logprob`` -> ``likelihood.nll_batched``), float64.

    python tools/sampler_profile.py [--evals 100] [--out FILE]

For the two posteriors the samplers run in ``chip_smoke.py``: the
pendulum's (N = 18, 4 chains, ``eval/posterior.py``) and the tokamak's
(N = 80, 8 chains, the CLI's ``sample tokamak``).  For each, and for each
linear-algebra backend torch offers for the batched Cholesky
(``torch.backends.cuda.preferred_linalg_library``: ``default``,
``cusolver``, ``magma``): ms per evaluation by the host clock around
``--evals`` evaluations ended by a synchronise, the host syncs one
evaluation makes (``torch.cuda.set_sync_debug_mode``), the kernels the
card runs for one evaluation and their summed device time
(``torch.profiler``), and the ten operators of most host time and of most
device time.  One JSON line per posterior and backend; ``--out`` appends
them to a file too.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sympgpr_tpu_torch import __main__ as cli  # noqa: E402
from sympgpr_tpu_torch.eval import posterior as post  # noqa: E402
from sympgpr_tpu_torch.gp import hmc  # noqa: E402


def _problems(dev):
    prob = post.pendulum_problem(dev)
    kern, X, z, sig2n, x0 = cli._sample_problem("tokamak", dev)
    return {
        "pendulum_n18_c4": (prob["logprob"], torch.as_tensor(
            np.tile([1.7, 1.2, 2.5], (4, 1)), device=dev)),
        "tokamak_n80_c8": (hmc.nll_logprob(kern, X, z, sig2n),
                           torch.as_tensor(hmc.start_points(x0, 8, 0),
                                           device=dev)),
    }


def _syncs(fn) -> int:
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(x.message) for x in w)


def _profile(fn, reps: int = 5) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    dev_us = [(e.key, e.self_device_time_total / reps, e.count / reps)
              for e in ka if e.self_device_time_total > 0]
    host_us = [(e.key, e.self_cpu_time_total / reps, e.count / reps)
               for e in ka]
    kernels = sum(e.count for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / reps
    dev_us.sort(key=lambda t: -t[1])
    host_us.sort(key=lambda t: -t[1])
    return dict(kernels_per_eval=kernels,
                device_busy_ms=sum(t[1] for t in dev_us) / 1e3,
                top_device_us=[(k, round(v, 1), c) for k, v, c in dev_us[:10]],
                top_host_us=[(k, round(v, 1), c) for k, v, c in host_us[:10]])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--evals", type=int, default=100)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sampler_profile: no CUDA device")
    dev = torch.device("cuda", 0)
    for name, (logprob, x) in _problems(dev).items():
        for backend in ("default", "cusolver", "magma"):
            torch.backends.cuda.preferred_linalg_library(backend)

            def one():
                return hmc.value_and_grad(logprob, x)

            for _ in range(5):
                one()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.evals):
                one()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / args.evals
            line = dict(posterior=name, linalg=backend, ms_per_eval=ms,
                        syncs_per_eval=_syncs(one), **_profile(one),
                        device=torch.cuda.get_device_name(0))
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    torch.backends.cuda.preferred_linalg_library("default")


if __name__ == "__main__":
    main()
