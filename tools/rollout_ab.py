#!/usr/bin/env python3
"""Time the PyTorch port's fused rollout kernel of one or more checkouts of
this repository in turns, on one CUDA card.

    python tools/rollout_ab.py --trees OLD . . OLD [--sweep] [--cluster]

Each entry of ``--trees`` is the root of a checkout; each runs in its own
process, with its own ``sympgpr_tpu_torch`` package and kernel build, on
the same models and initial conditions:

* models: the tokamak section crossings of ``systems/tokamak.py`` at
  N = 80 and N = 4096 (the reference size and ``tokamak_large``), per_se
  GPs at fixed hyperparameters (lx, ly, sig = 0.541, 1.391, 26.55, the
  N = 4096 fit's), re-solved at the deployment jitter, the aux GP on the
  first 80 / 512 crossings;
* initial conditions: the 30 reference test orbits, tiled to the batch.

* the Split tokamak's shape: the crossings of ``tokamak_split``'s
  configuration (N = 70 for each of 4 sub-maps of a quarter turn, nph =
  100) at fixed hyperparameters (``HYP_SPLIT``, the order of its CMA-ES
  fits), aux GPs on the same crossings, its 30 test orbits; and its first
  sub-map alone at the same shape, through the one-map instance.
* the standard map's shapes: exact pairs of the Chirikov map (k = 2) at
  N = 20 and N = 4096, per_se (implicit, the aux GP on the first 20 / 512
  pairs) or sum_per_se (Algorithm 2) at fixed hyperparameters
  (``HYP_STDMAP``, ``HYP_STDMAP_SUM``: the N = 20 fits'), mod_p = 2 pi
  with pdiff and 8 Newton iterations as ``standard_map`` runs them, its
  30 test orbits tiled to the batch.

Shapes (orbits x steps, N, dtype): the four float32 shapes of
``chip_smoke.py``'s ``rollout_shapes`` phase (the bench batch 32768 x 1000
and the reference size 30 x 1000 at N = 80, ``tokamak_large``'s apply
30 x 1000 and its rollout batch 4096 x 256 at N = 4096), then 32768 x 1000,
N = 80 and 30 x 100, N = 4096 in float64, then the Split shape 30 x 4000
at N = 70 with 4 sub-maps and with the first alone, in float32 (a
checkout without Split cycling prints the first as refused), then the
standard map's: 32768 x 1000 at N = 20 with mod_p and pdiff, implicit and
Algorithm 2, in float32 (and implicit in float64), and ``standard_map_large``'s
30 x 200 at N = 4096 (a checkout without these modes prints them as
refused).  Each is timed with CUDA events, best and median
of ``--reps`` after one warm-up; ``digest`` is a hash of the trajectory's
bytes, equal across checkouts whose kernels give the same bits.  ``--sweep`` also times
every team size the kernel takes, and each shape prints its geometry
(checkouts whose kernel runs teams of lanes, ``launch_geometry``).
``--probe`` times the bench batch once more without the loss check and
once with no Newton iteration.  ``--cluster`` times the implicit one-map
rollout with the loss check at clusters of C = 1, 2, 4 and 8 blocks an
orbit (``_launch(..., cluster=C)``; C = 1 is the one-block team) at
30 x 1000 for N = 80, 1024, 2048 and 4096, 4096 x 256 at N = 4096 and
32768 x 1000 at N = 80, with the cluster the launch's rule picks and a
``digest`` for each C; a checkout without cluster teams times its own
launch as C = 1.  Prints one JSON line per checkout and
shape, one with the checkout's nvcc time for each rollout library it has
(``build_s``: ``rollout_step.cu`` and, where the checkout has it,
``rollout_split_modes.cu``, one after the other, nothing built before them
in that process) and their ptxas report, then the card's ``nvidia-smi``
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import LARGE, ROLLOUT_SHAPES  # noqa: E402

HYP = (0.541, 1.391, 26.55)
HYP_SPLIT = (1.3, 3.0, 7.0)
HYP_STDMAP = (10.77, 5.295, 80.66)      # lx, ly, sig; aux (0.1, 0.1, 8.0)
HYP_STDMAP_AUX = (0.1, 0.1, 8.0)
HYP_STDMAP_SUM = (8.777, 4.161, 80.66)
SPLIT = dict(N=70, nphmap=4, nph=100, r_scale=0.38, qminmap=0.16,
             qmaxmap=0.31)  # sympgpr_tpu_torch.__main__.SPLIT
MODELS = {  # name: training points, aux points, sub-maps
    "n80": (80, 80, 1), "n4096": (LARGE["n_train"], LARGE["aux_subsample"],
                                  1),
    "split_n70": (70, 70, 4), "split_n70_m1": (70, 70, 1),
    "stdmap_n20": (20, 20, 1), "stdmap_sum_n20": (20, 0, 1),
    "stdmap_n4096": (4096, 512, 1), "n1024": (1024, 512, 1),
    "n2048": (2048, 512, 1)}
SHAPES = [  # name, model, orbits, steps, dtype
    *((name, model, batch, nm, "float32")
      for name, (batch, nm, model) in ROLLOUT_SHAPES.items()),
    ("bench_32768x1000_n80_f64", "n80", 32768, 1000, "float64"),
    ("f64_30x100_n4096", "n4096", 30, 100, "float64"),
    ("split_30x4000_n70_m4", "split_n70", 30, 4000, "float32"),
    # its first sub-map alone, through the one-map instance: the floor of
    # the cycling's cost at the same shape
    ("split_30x4000_n70_m1", "split_n70_m1", 30, 4000, "float32"),
    ("stdmap_32768x1000_n20", "stdmap_n20", 32768, 1000, "float32"),
    ("stdmap_sum_32768x1000_n20", "stdmap_sum_n20", 32768, 1000, "float32"),
    ("stdmap_32768x1000_n20_f64", "stdmap_n20", 32768, 1000, "float64"),
    ("stdmap_large_30x200_n4096", "stdmap_n4096", 30, 200, "float32"),
]
CLUSTERS = (1, 2, 4, 8)
CLUSTER_SHAPES = [  # name, model, orbits, steps (float32)
    ("large_apply_30x1000_n4096", "n4096", 30, 1000),
    ("30x1000_n2048", "n2048", 30, 1000),
    ("30x1000_n1024", "n1024", 30, 1000),
    ("ref_30x1000_n80", "n80", 30, 1000),
    ("large_batch_4096x256_n4096", "n4096", 4096, 256),
    ("bench_32768x1000_n80", "n80", 32768, 1000),
]


def _models(model: str, dev):
    """Deployment-conditioned (sgp, aux) pairs, one per sub-map."""
    import torch

    from sympgpr_tpu_torch.gp.model import AuxGP, SympGP
    from sympgpr_tpu_torch.kernels import PER_SE
    from sympgpr_tpu_torch.systems import tokamak as tk

    n, na, n_maps = MODELS[model]
    if model.startswith("stdmap"):
        return _stdmap_models(model, dev)
    split = model.startswith("split")
    cfg = tk.TokamakConfig(**SPLIT) if split else tk.TokamakConfig(N=n)
    hyp = HYP_SPLIT if split else HYP
    data = tk.training_data(cfg, dev)
    pairs = []
    for m in range(cfg.nphmap):
        q, p = data["q"][:, m], data["p"][:, m]
        Q, P = data["Q"][:, m], data["P"][:, m]
        X = torch.stack([q, P], 1)
        z = torch.cat([p - P, Q - q])
        sgp = SympGP.create(PER_SE, hyp[:2], hyp[2], 1e-2, X, z)
        aux = AuxGP.create(PER_SE, hyp[:2], hyp[2], 1e-2,
                           torch.stack([q[:na], p[:na]], 1), (P - p)[:na])
        pairs.append((sgp.for_deployment(1e-3), aux.for_deployment(1e-3)))
    return pairs[:n_maps]


def _stdmap_models(model: str, dev):
    """The standard map's (sgp, aux) at fixed hyperparameters; no aux
    model for sum_per_se."""
    import torch

    from sympgpr_tpu_torch.gp.model import AuxGP, SympGP
    from sympgpr_tpu_torch.kernels import PER_SE, SUM_PER_SE
    from sympgpr_tpu_torch.systems import standard_map as sm

    n, na, _ = MODELS[model]
    data = sm.training_data(sm.StandardMapConfig(N=n), dev)
    if model.startswith("stdmap_sum"):
        lx, ly, sig = HYP_STDMAP_SUM
        return [(SympGP.create(SUM_PER_SE, (lx, ly), sig, 1e-5, data["X"],
                               data["z"]), None)]
    lx, ly, sig = HYP_STDMAP
    alx, aly, asig = HYP_STDMAP_AUX
    sgp = SympGP.create(PER_SE, (lx, ly), sig, 1e-5, data["X"], data["z"])
    aux = AuxGP.create(PER_SE, (alx, aly), asig, 1e-5, data["Xp"][:na],
                       data["zp"][:na], delta=True)
    return [(sgp, aux)]


def _stdmap_ics(dev, dtype, batch: int):
    import torch

    from sympgpr_tpu_torch.systems import standard_map as sm

    q0, p0 = sm.test_initial_conditions(sm.StandardMapConfig())
    reps = -(-batch // len(q0))
    return tuple(torch.tensor(x, dtype=dtype, device=dev).repeat(reps)
                 [:batch].contiguous() for x in (q0, p0))


def _digest(*ts) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _ics(dev, dtype, batch: int, split: bool = False):
    from sympgpr_tpu_torch.systems import tokamak as tk

    cfg = tk.TokamakConfig(**SPLIT) if split else tk.TokamakConfig()
    (r0, th0), _ = tk.test_initial_conditions(cfg)
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
    """registers / spills / stack of each rollout kernel instance (of
    every rollout library built)."""
    out = {}
    for log in sorted(build_dir.glob("librollout_*-*.log")):
        kernel = None
        for ln in log.read_text().splitlines():
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1]
                out[kernel] = []
            elif kernel and ("registers" in ln or "spill" in ln
                             or "stack" in ln):
                out[kernel].append(ln.split(": ", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def cluster_sweep(tree: str, cs, models: dict, dev, reps: int) -> None:
    """One JSON line per shape of ``CLUSTER_SHAPES``: ms (best of
    ``reps``) and a digest of the trajectory for each forced cluster, and
    the geometry the rule picks."""
    import torch

    clusters = hasattr(cs, "CLUSTER_MAX")
    for name, model, batch, nm in CLUSTER_SHAPES:
        if model not in models:
            models[model] = _models(model, dev)
        pm = cs.pack_models(*models[model][0], mod_q=2 * math.pi)
        q0, p0 = _ics(dev, torch.float32, batch)
        row = dict(tree=tree, cluster_sweep=name, orbits=batch, nm=nm,
                   ns=pm.ns, nas=pm.nas, ms={}, digest={}, refused={})
        for c in CLUSTERS if clusters else (1,):
            kw = dict(cluster=c) if clusters else {}
            try:
                row["ms"][c] = _time(lambda: cs._launch(
                    pm, q0, p0, nm, 5, True, **kw), reps)[0]
            except (ValueError, RuntimeError) as e:
                row["refused"][c] = str(e)
                continue
            row["digest"][c] = _digest(*cs._launch(pm, q0, p0, nm, 5, True,
                                                   **kw))
        row["geometry"] = cs.launch_geometry(
            batch, pm.ns, pm.nas, torch.float32, torch.cuda
            .get_device_properties(dev).multi_processor_count).__dict__
        print(json.dumps(row), flush=True)


def run_one(tree: str, sweep: bool, probe: bool, reps: int,
            cluster: bool = False) -> None:
    # the tree's own package: importing chip_smoke above loaded this
    # checkout's
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "sympgpr_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from sympgpr_tpu_torch.ops import _build
    from sympgpr_tpu_torch.ops import cuda_step as cs

    dev = torch.device("cuda", 0)
    build_s = {}  # nvcc of this checkout's rollout libraries, in turn
    for lib in ("rollout_step", "rollout_split_modes"):
        if (_build.CSRC / f"{lib}.cu").exists():
            t0 = time.perf_counter()
            _build.load(lib)
            build_s[lib] = time.perf_counter() - t0
    teams = hasattr(cs, "launch_geometry")  # a kernel of teams of lanes
    models = {}
    for name, model, batch, nm, dt in SHAPES:
        dtype = getattr(torch, dt)
        if model not in models:
            try:
                models[model] = _models(model, dev)
            except ImportError as e:  # a checkout without the system
                models[model] = e
        pairs = models[model]
        if isinstance(pairs, ImportError):
            print(json.dumps(dict(tree=tree, shape=name, orbits=batch, nm=nm,
                                  dtype=dt, refused=str(pairs))), flush=True)
            continue
        split = len(pairs) > 1
        split_ics = model.startswith("split")
        row = dict(tree=tree, shape=name, n_maps=len(pairs), orbits=batch,
                   nm=nm, dtype=dt)
        if split and not hasattr(cs, "pack_models_split"):
            row["refused"] = "no Split cycling in this checkout"
            print(json.dumps(row), flush=True)
            continue
        stdmap = model.startswith("stdmap")
        if stdmap:  # mod_p and pdiff, 8 Newton iterations, no loss check
            pm = cs.pack_models(*pairs[0], mod_q=(
                None if model.startswith("stdmap_sum") else 2 * math.pi),
                mod_p=2 * math.pi, dtype=dtype)
            kw = dict(track_pdiff=True, iters=8)
            q0, p0 = _stdmap_ics(dev, dtype, batch)
        else:
            pm = (cs.pack_models_split(*map(list, zip(*pairs)),
                                       mod_q=2 * math.pi, dtype=dtype)
                  if split else
                  cs.pack_models(*pairs[0], mod_q=2 * math.pi, dtype=dtype))
            kw = dict(loss_check=True, **({"loss_at_new_q": True} if split
                                          else {}))
            q0, p0 = _ics(dev, dtype, batch, split_ics)
        row.update(ns=pm.ns, nas=pm.nas)
        try:
            best, med = _time(lambda: cs.rollout_in_kernel(
                pm, q0, p0, nm, **kw), reps)
        except (ValueError, RuntimeError) as e:
            row["refused"] = str(e)
            print(json.dumps(row), flush=True)
            continue
        out = cs.rollout_in_kernel(pm, q0, p0, nm, **kw)
        row.update(ms=best, median_ms=med,
                   orbit_steps_per_s=(nm - 1) * batch / (best * 1e-3),
                   lost=int(torch.isnan(out[1][-1]).sum()),
                   digest=_digest(*out))
        if teams:
            mode = ({"mode": cs.kernel_mode(
                pm.kind, kw.get("explicit", False), pm.mod_p is not None,
                kw.get("track_pdiff", False))}
                if hasattr(cs, "kernel_mode") else {})
            geo = cs.launch_geometry(
                batch, pm.ns, pm.nas, dtype, torch.cuda
                .get_device_properties(dev).multi_processor_count,
                **({"n_maps": len(pairs)} if split else {}), **mode)
            row["geometry"] = geo.__dict__
        if sweep and teams:
            row["team_ms"] = {}
            team = 1
            while team <= cs.team_max(dtype):
                if -(-pm.ns // team) <= cs.P_MAX:
                    tkw = dict(kw, loss_check=kw.get("loss_check", False))
                    iters = tkw.pop("iters", 5)
                    row["team_ms"][team] = _time(
                        lambda: cs._launch(pm, q0, p0, nm, iters, team=team,
                                           **tkw), max(1, reps // 2))[0]
                team *= 2
        if probe and name.startswith("bench") and dt == "float32":
            row["no_loss_check_ms"] = _time(lambda: cs.rollout_in_kernel(
                pm, q0, p0, nm, loss_check=False), reps)[0]
            row["iters0_ms"] = _time(lambda: cs.rollout_in_kernel(
                pm, q0, p0, nm, iters=0, loss_check=True), reps)[0]
        print(json.dumps(row), flush=True)
    if cluster:
        cluster_sweep(tree, cs, {k: v for k, v in models.items()
                                 if not isinstance(v, ImportError)}, dev,
                      max(1, reps // 2))
    print(json.dumps(dict(tree=tree, build_s=build_s,
                          ptxas=_ptxas(_build.BUILD_DIR))), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--cluster", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if args.one:
        run_one(args.one, args.sweep, args.probe, args.reps, args.cluster)
        return
    for tree in args.trees:
        cmd = [sys.executable, __file__, "--one", tree, "--reps",
               str(args.reps)] + (["--sweep"] if args.sweep else []) \
            + (["--probe"] if args.probe else []) \
            + (["--cluster"] if args.cluster else [])
        subprocess.run(cmd, check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
