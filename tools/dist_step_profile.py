#!/usr/bin/env python3
"""Time the PyTorch port's distributed large-N step on one CUDA card, for
one or more checkouts of this repository in turns.

    python tools/dist_step_profile.py --trees OLD . . OLD [--reps 3]

Each entry of ``--trees`` is the root of a checkout; each runs in its own
process, with its own ``sympgpr_tpu_torch``, as a world of one rank on
NCCL, on the synthetic problem of ``workloads/large_n.py::
run_distributed`` at ``--n`` (4096 by default: K 8192 x 8192, float32,
block 64, sig2n 1e-2, at theta0).  Per tree, one JSON line:

* ``first_s``: the process's first calls, each synchronised: starting the
  group (``distributed/init.py::initialize``), the first collective, the
  first slab build, the first factorization without tangents, the first
  value and gradient and the second (allocator growth, library handles,
  lazy module loads, NCCL's communicator);
* ``factor_ms``, ``vg_ms``: one robust factorization without tangents,
  and one value and gradient (a distributed Adam step), best and median
  over ``--reps`` by CUDA events;
* ``factor_host_ms``: the host's time to issue one ``_factorize_cyclic``
  (it holds no host sync; the card may still be busy when it returns);
* ``vg_device_busy_ms``, ``vg_kernels``, ``vg_top``: the profiler's sum of
  the card's kernel time in one value and gradient, its kernel count and
  its kernels of most device time (ms, calls).

Then the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _events_ms(fn, reps: int) -> tuple[float, float]:
    """Best and median ms of one call by CUDA events, after a warm-up."""
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


def run_one(tree: str, N: int, reps: int) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile

    from sympgpr_tpu_torch.distributed import init as dinit
    from sympgpr_tpu_torch.distributed import large
    from sympgpr_tpu_torch.kernels import PER_SE
    from sympgpr_tpu_torch.workloads import large_n

    def sync():
        torch.cuda.synchronize()

    first = {}
    t0 = time.perf_counter()
    dev = dinit.initialize("cuda")
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("kp",))
    first["initialize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist.all_reduce(torch.zeros(1, device=dev))
    sync()
    first["first_collective"] = time.perf_counter() - t0
    X, z = large_n.synthetic_training_set(N, torch.float32, device=dev)
    theta = torch.tensor(large_n.DIST_X0, dtype=torch.float32, device=dev)
    s2n = torch.tensor(1e-2, dtype=torch.float32, device=dev)
    block = 64

    def vg():
        return large.sharded_nll_large_value_and_grad(
            PER_SE, mesh, theta, s2n, X, z, block=block)

    group = mesh.get_group("kp")
    n_pad, nb, nb_loc = large._geometry(N, 1, block)
    hyp = 10.0 ** theta
    factor = large._factorize_robust
    t0 = time.perf_counter()
    slab = large.build_K_cyclic(PER_SE, mesh, hyp[:-1], hyp[-1], s2n, X,
                                block=block)[0]
    sync()
    first["first_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    factor(slab, None, 2 * N, 0, group, 1, nb, nb_loc, block)
    sync()
    first["first_factor"] = time.perf_counter() - t0
    for key in ("first_vg", "second_vg"):
        t0 = time.perf_counter()
        vg()
        sync()
        first[key] = time.perf_counter() - t0
    res = {"tree": tree, "N": N, "torch": torch.__version__,
           "device": torch.cuda.get_device_name(0), "first_s": first}
    res["factor_ms"] = _events_ms(
        lambda: factor(slab, None, 2 * N, 0, group, 1, nb, nb_loc, block),
        reps)
    res["vg_ms"] = _events_ms(vg, reps)
    hosts = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        large._factorize_cyclic(slab, None, 0, group, 1, nb, nb_loc, block)
        hosts.append(1e3 * (time.perf_counter() - t0))
        sync()
    res["factor_host_ms"] = min(hosts)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        vg()
        sync()
    rows = [(e.key, (getattr(e, "device_time_total", 0)
                     or getattr(e, "cuda_time_total", 0)) / 1e3, e.count)
            for e in prof.key_averages()]
    kernels = [r for r in rows if r[1] > 0]
    res["vg_device_busy_ms"] = sum(r[1] for r in kernels)
    res["vg_kernels"] = sum(r[2] for r in kernels)
    res["vg_top"] = [[k[:60], ms, c] for k, ms, c in
                     sorted(kernels, key=lambda r: -r[1])[:10]]
    print(json.dumps(res), flush=True)
    dinit.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run_one(args.one, args.n, args.reps)
        return
    for tree in args.trees:
        subprocess.run([sys.executable, __file__, "--one", tree, "--n",
                        str(args.n), "--reps", str(args.reps)], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
