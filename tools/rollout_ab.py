#!/usr/bin/env python3
"""Time the PyTorch port's fused rollout kernel of one or more checkouts of
this repository in turns, on one CUDA card.

    python tools/rollout_ab.py --trees OLD . . OLD [--sweep]

Each entry of ``--trees`` is the root of a checkout; each runs in its own
process, with its own ``sympgpr_tpu_torch`` package and kernel build, on
the same models and initial conditions:

* models: the tokamak section crossings of ``systems/tokamak.py`` at
  N = 80 and N = 4096 (the reference size and ``tokamak_large``), per_se
  GPs at fixed hyperparameters (lx, ly, sig = 0.541, 1.391, 26.55, the
  N = 4096 fit's), re-solved at the deployment jitter, the aux GP on the
  first 80 / 512 crossings;
* initial conditions: the 30 reference test orbits, tiled to the batch.

Shapes (orbits x steps, N, dtype): the four float32 shapes of
``chip_smoke.py``'s ``rollout_shapes`` phase (the bench batch 32768 x 1000
and the reference size 30 x 1000 at N = 80, ``tokamak_large``'s apply
30 x 1000 and its rollout batch 4096 x 256 at N = 4096), then 32768 x 1000,
N = 80 and 30 x 100, N = 4096 in float64.  Each is timed with CUDA events,
best and median of ``--reps`` after one warm-up.  ``--sweep`` also times
every team size the kernel takes, and each shape prints its geometry
(checkouts whose kernel runs teams of lanes, ``launch_geometry``).
``--probe`` times the bench batch once more without the loss check and
once with no Newton iteration.  Prints one JSON line per checkout and
shape, then the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import LARGE, ROLLOUT_SHAPES  # noqa: E402

HYP = (0.541, 1.391, 26.55)
MODELS = {"n80": (80, 80), "n4096": (LARGE["n_train"],
                                     LARGE["aux_subsample"])}
SHAPES = [  # name, N, aux points, orbits, steps, dtype
    *((name, *MODELS[model], batch, nm, "float32")
      for name, (batch, nm, model) in ROLLOUT_SHAPES.items()),
    ("bench_32768x1000_n80_f64", *MODELS["n80"], 32768, 1000, "float64"),
    ("f64_30x100_n4096", *MODELS["n4096"], 30, 100, "float64"),
]


def _models(n: int, na: int, dev):
    import torch

    from sympgpr_tpu_torch.gp.model import AuxGP, SympGP
    from sympgpr_tpu_torch.kernels import PER_SE
    from sympgpr_tpu_torch.systems import tokamak as tk

    data = tk.training_data(tk.TokamakConfig(N=n), dev)
    q, p = data["q"][:, 0], data["p"][:, 0]
    Q, P = data["Q"][:, 0], data["P"][:, 0]
    X = torch.stack([q, P], 1)
    z = torch.cat([p - P, Q - q])
    sgp = SympGP.create(PER_SE, HYP[:2], HYP[2], 1e-2, X, z)
    aux = AuxGP.create(PER_SE, HYP[:2], HYP[2], 1e-2,
                       torch.stack([q[:na], p[:na]], 1), (P - p)[:na])
    return sgp.for_deployment(1e-3), aux.for_deployment(1e-3)


def _ics(dev, dtype, batch: int):
    from sympgpr_tpu_torch.systems import tokamak as tk

    (r0, th0), _ = tk.test_initial_conditions(tk.TokamakConfig())
    pth0, q0 = tk.ics_to_pth(r0, th0, dev)
    reps = -(-batch // len(r0))
    q0 = q0.repeat(reps)[:batch].to(dtype).contiguous()
    p0 = (pth0 * 1e2).repeat(reps)[:batch].to(dtype).contiguous()
    return q0, p0


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


def _ptxas(build_dir: Path) -> dict:
    """registers / spills / stack of each rollout kernel instance."""
    out = {}
    for log in sorted(build_dir.glob("librollout_step-*.log")):
        kernel = None
        for ln in log.read_text().splitlines():
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1]
                out[kernel] = []
            elif kernel and ("registers" in ln or "spill" in ln
                             or "stack" in ln):
                out[kernel].append(ln.split(": ", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def run_one(tree: str, sweep: bool, probe: bool, reps: int) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from sympgpr_tpu_torch.ops import _build
    from sympgpr_tpu_torch.ops import cuda_step as cs

    dev = torch.device("cuda", 0)
    teams = hasattr(cs, "launch_geometry")  # a kernel of teams of lanes
    models = {}
    for name, n, na, batch, nm, dt in SHAPES:
        dtype = getattr(torch, dt)
        if n not in models:
            models[n] = _models(n, na, dev)
        pm = cs.pack_models(*models[n], mod_q=2 * math.pi, dtype=dtype)
        q0, p0 = _ics(dev, dtype, batch)
        row = dict(tree=tree, shape=name, ns=pm.ns, nas=pm.nas,
                   orbits=batch, nm=nm, dtype=dt)
        try:
            best, med = _time(lambda: cs.rollout_in_kernel(
                pm, q0, p0, nm, loss_check=True), reps)
        except (ValueError, RuntimeError) as e:
            row["refused"] = str(e)
            print(json.dumps(row), flush=True)
            continue
        _, P = cs.rollout_in_kernel(pm, q0, p0, nm, loss_check=True)
        row.update(ms=best, median_ms=med,
                   orbit_steps_per_s=(nm - 1) * batch / (best * 1e-3),
                   lost=int(torch.isnan(P[-1]).sum()))
        if teams:
            geo = cs.launch_geometry(batch, pm.ns, pm.nas, dtype, torch.cuda
                                     .get_device_properties(dev)
                                     .multi_processor_count)
            row["geometry"] = geo.__dict__
        if sweep and teams:
            row["team_ms"] = {}
            team = 1
            while team <= cs.team_max(dtype):
                if -(-pm.ns // team) <= cs.P_MAX:
                    row["team_ms"][team] = _time(
                        lambda: cs._launch(pm, q0, p0, nm, 5,
                                           loss_check=True, team=team),
                        max(1, reps // 2))[0]
                team *= 2
        if probe and name.startswith("bench") and dt == "float32":
            row["no_loss_check_ms"] = _time(lambda: cs.rollout_in_kernel(
                pm, q0, p0, nm, loss_check=False), reps)[0]
            row["iters0_ms"] = _time(lambda: cs.rollout_in_kernel(
                pm, q0, p0, nm, iters=0, loss_check=True), reps)[0]
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(tree=tree, ptxas=_ptxas(_build.BUILD_DIR))),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if args.one:
        run_one(args.one, args.sweep, args.probe, args.reps)
        return
    for tree in args.trees:
        cmd = [sys.executable, __file__, "--one", tree, "--reps",
               str(args.reps)] + (["--sweep"] if args.sweep else []) \
            + (["--probe"] if args.probe else [])
        subprocess.run(cmd, check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
