"""Command-line interface of the PyTorch port.

  python -m sympgpr_tpu_torch list
  python -m sympgpr_tpu_torch run tokamak --nm 1000 --device cuda
  python -m sympgpr_tpu_torch run tokamak_kernel --device cuda
  python -m sympgpr_tpu_torch run tokamak_split --device cuda
  python -m sympgpr_tpu_torch run tokamak_split_kernel --device cuda
  python -m sympgpr_tpu_torch run tokamak_large --n 4096 --steps 40 --device cuda
  python -m sympgpr_tpu_torch run standard_map_kernel --device cuda
  python -m sympgpr_tpu_torch run standard_map_large --device cuda
  python -m sympgpr_tpu_torch run pendulum_explicit_kernel --device cuda
  python -m sympgpr_tpu_torch run pert_pendulum_kernel --device cuda
  python -m sympgpr_tpu_torch run henon_heiles_kernel --device cuda
  python -m sympgpr_tpu_torch run tokamak_kernel --optimizer adam --device cuda
  python -m sympgpr_tpu_torch sample tokamak --sampler nuts --device cuda
  python -m sympgpr_tpu_torch sample pendulum_implicit --sampler hmc --device cuda
  python -m sympgpr_tpu_torch sobol --n 128 --turns 30 --device cuda
  python -m sympgpr_tpu_torch run large_n --n 4096 --device cuda
  python -m sympgpr_tpu_torch run large_n --distributed --device cuda
  python -m torch.distributed.run --nproc-per-node 4 -m sympgpr_tpu_torch run large_n --distributed
  python -m sympgpr_tpu_torch run pendulum_implicit --backend kernel --plots out/
  python -m sympgpr_tpu_torch bench --device cuda
  python -m sympgpr_tpu_torch bench --large-n --n 4096 --device cuda
  python -m sympgpr_tpu_torch bench --large-n --distributed --steps 20 --device cuda
  python -m sympgpr_tpu_torch bench --rollout-sweep --device cuda

Each workload without ``_kernel`` rolls out on the float64 fast path; with
it, through the fused rollout in float32.  ``--backend kernel`` (or
``pallas``) and ``--backend generic`` choose that over the name's own, and
the JAX package's names ``tokamak_pallas``, ``pendulum_pallas`` and
``henon_pallas`` run the ``_kernel`` workloads.  ``--plots DIR`` writes the
run's Poincare portrait.  ``sample`` draws a workload's GP hyperposterior
(log10 hyperparameters, sig last) with NUTS or adaptive HMC, all chains
batched in float64; ``sobol`` computes the tokamak's Sobol indices over
(eps, phase); ``run large_n`` and ``bench --large-n`` time the large-N
pipeline's stages, ``bench --rollout-sweep`` the rollout kernel over
training-set sizes (``workloads/large_n.py``); with ``--distributed`` both
run the block-cyclic fit over the ranks of ``torch.distributed``
(``large_n.run_distributed``: one rank, or the launcher's, each on
``cuda:LOCAL_RANK``; the JSON is printed by rank 0).  All print the JSON
keys of the JAX CLI.  The plain ``bench`` runs the headline benchmark
(``bench.py``): the detail, then ``tokamak_rollout_orbit_steps_per_s`` as
the last line.

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
# the standard map, the pendulum, the perturbed pendulum and Henon-Heiles
# at the JAX CLI's configurations: name -> (workload module, backend, run
# keywords, config fields, nm)
OTHERS = {
    **{f"standard_map{m}{k}": ("standard_map", b,
                               {"method": m[1:] or "implicit"}, {}, 100)
       for m in ("", "_explicit")
       for k, b in (("", "generic"), ("_kernel", "kernel"))},
    **{f"pendulum_{name}{k}": (f"pendulum_{name}", b, {}, fields, 1000)
       for name, fields in (("implicit", {}),
                            ("explicit", {"Nm": 70, "sig2_n": 1e-10}),
                            ("period_unknown", {"N": 50, "Nm": 100,
                                                "sig2_n": 1e-10}))
       for k, b in (("", "generic"), ("_kernel", "kernel"))},
    **{f"{name}{k}": (name, b, {}, {}, nm)
       for name, nm in (("pert_pendulum", 100), ("henon_heiles", 500))
       for k, b in (("", "generic"), ("_kernel", "kernel"))},
    "standard_map_large": None,
}
# the JAX package's names of the fused-rollout workloads
ALIASES = {"tokamak_pallas": "tokamak_kernel",
           "pendulum_pallas": "pendulum_implicit_kernel",
           "henon_pallas": "henon_heiles_kernel"}
# workload module -> (system module, its config class); the pendulum's
# three workloads share PendulumConfig
CONFIGS = {
    "standard_map": ("standard_map", "StandardMapConfig"),
    "pert_pendulum": ("pert_pendulum", "PertPendulumConfig"),
    "henon_heiles": ("henon_heiles", "HenonConfig"),
}


def _summarize(out: dict) -> dict:
    """The keys ``sympgpr_tpu.__main__._summarize`` prints."""
    s = {k: out[k] for k in ("training_error", "t_train", "t_apply",
                             "one_step_mse", "period_ratio", "n_lost",
                             "n_train", "method", "optimizer") if k in out}
    for k in ("Eosc", "gd", "Eosc_se"):
        if k in out:
            s[f"mean_{k}"] = float(np.nanmean(out[k]))
    if "hyp" in out:
        s["hyp"] = np.asarray(out["hyp"]).tolist()
    return s


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return device


def _names() -> list[str]:
    """Every workload name the port runs: its own, ``large_n`` and the
    JAX package's aliases."""
    return sorted({**WORKLOADS, **OTHERS, "large_n": None, **ALIASES})


def resolve(name: str, backend: str | None = None) -> str:
    """The port's workload for a name of either package and ``--backend``
    (``generic``, or ``kernel`` / its alias ``pallas``), which overrides
    the name's own backend where the workload has both; unknown names
    exit."""
    if name not in _names():
        sys.exit(f"unknown workload {name!r}; available: {_names()}")
    name = ALIASES.get(name, name)
    base = name.removesuffix("_kernel")
    if backend is not None and f"{base}_kernel" in _names() \
            and base in _names():
        name = base if backend == "generic" else f"{base}_kernel"
    return name


def _run_other(name, args, device) -> dict:
    import importlib

    name, backend, kw, fields, nm = OTHERS[name]
    wl = importlib.import_module(f"sympgpr_tpu_torch.workloads.{name}")
    system, config = CONFIGS.get(name, ("pendulum", "PendulumConfig"))
    Config = getattr(importlib.import_module(
        f"sympgpr_tpu_torch.systems.{system}"), config)
    cfg = Config(**fields, nm=args.nm or nm)
    return wl.run(cfg, backend=backend, **kw, device=device)


def _run_large(name, args, device) -> dict:
    """``large_n``, ``tokamak_large`` and ``standard_map_large``: their
    whole result dict, without the fitted models."""
    if name == "large_n":
        from sympgpr_tpu_torch.workloads import large_n

        if args.distributed:
            return large_n.run_distributed(N=args.n or 1024,
                                           steps=args.steps or 20,
                                           device=device)
        return large_n.measure(N=args.n or 4096, device=device)
    sig2n = {"sig2n": args.sig2n} if args.sig2n else {}
    if name == "tokamak_large":
        from sympgpr_tpu_torch.workloads import tokamak_large

        out = tokamak_large.run(
            n_train=args.n or 4096, nm=args.nm or 1000,
            steps=args.steps or 40, plots=args.plots, **sig2n, device=device)
    else:
        from sympgpr_tpu_torch.workloads import standard_map

        out = standard_map.run_large(
            n_train=args.n or 4096, nm=args.nm or 200,
            steps=args.steps or 60, **sig2n, device=device)
    out.pop("models")
    return out


def _run_tokamak(name, args, device) -> dict:
    from sympgpr_tpu_torch.systems import tokamak as tk
    from sympgpr_tpu_torch.systems.tokamak import TokamakConfig
    from sympgpr_tpu_torch.workloads import tokamak

    backend, fields, nm, optimizer = WORKLOADS[name]
    cfg = TokamakConfig(**fields, nm=args.nm or nm)
    out = tokamak.run(cfg, optimizer=args.optimizer or optimizer,
                      backend=backend, with_reference=args.with_reference,
                      device=device)
    if "gd" not in out:
        (r0, th0), _ = tk.test_initial_conditions(cfg)
        out.update(tokamak.one_turn_gd(cfg, out["traj"], r0, th0, device))
    return out


def cmd_run(args) -> dict:
    """Run a workload; print its summary (the large-N ones: their whole
    result) and, with ``--plots``, write its portrait.  Returns the
    result."""
    name = resolve(args.workload, args.backend)
    if args.distributed and name != "large_n":
        sys.exit("--distributed runs large_n only")
    device = _device(args.device)
    if args.plots:
        # portraits need matplotlib: fail before the run, not after it
        import matplotlib  # noqa: F401
    if name in ("large_n", "tokamak_large", "standard_map_large"):
        out = _run_large(name, args, device)
        _print_rank0(out)
        return out
    run = _run_other if name in OTHERS else _run_tokamak
    out = run(name, args, device)
    print(json.dumps(_summarize(out), default=str))
    if args.plots and "traj" in out:
        import os

        from sympgpr_tpu_torch import plotting

        os.makedirs(args.plots, exist_ok=True)
        traj = out["traj"]
        p = plotting.portrait(
            traj.q.cpu().numpy(), traj.p.cpu().numpy(),
            path=os.path.join(args.plots, f"{args.workload}_portrait.png"),
            title=args.workload)
        print(f"wrote {p}")
    return out


def _print_rank0(out: dict) -> None:
    """Print the JSON line once: on rank 0 of a distributed run."""
    import os

    if int(os.environ.get("RANK", 0)) == 0:
        print(json.dumps(out, default=str))


def cmd_list(args):
    for name in _names():
        print(name)


def cmd_bench(args) -> dict:
    """The headline benchmark (``bench.main``: the tokamak fit, the CPU
    baseline and the orbit rollouts, headline orbit-steps/s last);
    ``--large-n``: the large-N pipeline's stages at ``--n``
    (``large_n.measure``), headline build + Cholesky GFLOP/s; with
    ``--distributed``, the block-cyclic fit of ``--steps`` Adam steps
    (``large_n.run_distributed``), headline its seconds;
    ``--rollout-sweep``: the rollout kernel over training-set sizes."""
    if (args.distributed or args.steps is not None) and not (
            args.large_n and args.distributed):
        sys.exit("bench: --distributed and --steps go with --large-n "
                 "--distributed")
    device = _device(args.device)
    if not (args.large_n or args.rollout_sweep):
        from sympgpr_tpu_torch import bench

        return bench.main(device)
    from sympgpr_tpu_torch.workloads import large_n

    if args.distributed:
        detail = large_n.run_distributed(N=args.n, steps=args.steps or 20,
                                         device=device)
        out = {"metric": "large_n_distributed_fit_s",
               "value": detail["t_train_s"], "unit": "s", "detail": detail}
        _print_rank0(out)
        return out
    if args.rollout_sweep:
        out = {"metric": "rollout_sweep",
               "detail": large_n.rollout_sweep(device=device)}
    else:
        detail = large_n.measure(N=args.n, reps=args.reps, device=device)
        out = {"metric": "large_n_build_plus_cholesky_gflops",
               "value": detail["build_plus_chol_gflops"],
               "unit": "GFLOP/s", "detail": detail}
    print(json.dumps(out))
    return out


def cmd_sobol(args) -> dict:
    from sympgpr_tpu_torch import sensitivity

    device = _device(args.device)
    qoi = sensitivity.tokamak_chaos_qoi(n_turns=args.turns)
    S1, ST, var = sensitivity.sobol_indices(
        qoi, bounds=[(0.0, 0.004), (0.0, 2 * np.pi)], n=args.n,
        device=device)
    out = {"params": ["eps", "phase"], "S1": S1.tolist(), "ST": ST.tolist(),
           "var": float(var)}
    print(json.dumps(out))
    return out


SAMPLE_PROBLEMS = ("pendulum_implicit", "pendulum_period_unknown",
                   "standard_map", "tokamak")


def _sample_problem(name: str, device):
    """(kernel, X, z, sig2n, x0_theta) of the NLL posterior of a workload's
    symplectic GP (log10 hyperparameters, sig last), the JAX CLI's
    configurations."""
    import torch

    from sympgpr_tpu_torch.kernels import PER_SE, PER_SE_FREQ

    if name in ("pendulum_implicit", "pendulum_period_unknown"):
        from sympgpr_tpu_torch.systems import pendulum as sys_pend

        cfg = (sys_pend.PendulumConfig() if name == "pendulum_implicit"
               else sys_pend.PendulumConfig(N=50, Nm=100, sig2_n=1e-10))
        data = sys_pend.training_data(cfg, device)
        if name == "pendulum_implicit":
            return PER_SE, data["X"], data["z"], cfg.sig2_n, [0.0, 0.0, 0.5]
        return (PER_SE_FREQ, data["X"], data["z"], cfg.sig2_n,
                [0.0, 0.0, -0.3, 0.5])
    if name == "standard_map":
        from sympgpr_tpu_torch.systems import standard_map as sys_map

        cfg = sys_map.StandardMapConfig()
        data = sys_map.training_data(cfg, device)
        return PER_SE, data["X"], data["z"], cfg.sig2_n, [0.0, -0.5, 0.5]
    if name == "tokamak":
        from sympgpr_tpu_torch.systems import tokamak as tk

        cfg = tk.TokamakConfig()
        data = tk.training_data(cfg, device)
        q, p = data["q"][:, 0], data["p"][:, 0]
        Q, P = data["Q"][:, 0], data["P"][:, 0]
        return (PER_SE, torch.stack([q, P], 1), torch.cat([p - P, Q - q]),
                cfg.sig2_n, [-0.3, -0.3, 1.0])
    sys.exit(f"no sampling posterior registered for {name!r}; "
             f"available: {', '.join(SAMPLE_PROBLEMS)}")


def cmd_sample(args):
    """NUTS or adaptive HMC over a workload's GP hyperparameter posterior,
    all chains batched on ``--device``; returns (the printed dict, the
    sampler's result)."""
    import torch

    from sympgpr_tpu_torch.gp import hmc, nuts

    device = _device(args.device)
    kern, X, z, sig2n, x0 = _sample_problem(args.workload, device)
    logprob = hmc.nll_logprob(kern, X, z, sig2n)
    x0s = torch.as_tensor(hmc.start_points(x0, args.chains, args.seed),
                          dtype=torch.float64, device=device)
    common = dict(n_warmup=args.warmup, seed=args.seed,
                  step_size=args.step_size)
    if args.sampler == "nuts":
        res = nuts.sample_nuts(logprob, x0s, args.samples, **common)
        accept = res.accept_stat
        extra = {"mean_depth": float(res.mean_depth.mean()),
                 "divergences": int(res.n_divergent.sum())}
    else:
        res = hmc.sample_hmc(logprob, x0s, args.samples,
                             n_leapfrog=args.leapfrog, adapt_step_size=True,
                             **common)
        accept = res.accept_rate
        extra = {}

    samples = res.samples.cpu().numpy()  # (chains, n, dim) log10 theta
    flat = samples.reshape(-1, samples.shape[-1])
    hyp_names = [f"l{i}" for i in range(samples.shape[-1] - 1)] + ["sig"]
    out = {
        "workload": args.workload,
        "sampler": args.sampler,
        "chains": int(samples.shape[0]),
        "samples_per_chain": int(samples.shape[1]),
        "accept_rate": float(accept.mean()),
        "theta_mean": dict(zip(hyp_names, flat.mean(0).round(4).tolist())),
        "theta_std": dict(zip(hyp_names, flat.std(0).round(4).tolist())),
        "hyp_posterior_mean": dict(
            zip(hyp_names, (10.0 ** flat).mean(0).round(5).tolist())),
        **extra,
    }
    print(json.dumps(out))
    if args.save:
        np.savez(args.save, samples=samples,
                 log_probs=res.log_probs.cpu().numpy())
        print(f"wrote {args.save}", file=sys.stderr)
    return out, res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="sympgpr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="run a workload")
    p_run.add_argument("workload")
    p_run.add_argument("--nm", type=int, default=None,
                       help="number of map applications")
    p_run.add_argument("--optimizer", default=None,
                       choices=("lbfgs", "cmaes", "adam"),
                       help="hyperparameter optimizer of the tokamak "
                            "workloads")
    p_run.add_argument("--n", type=int, default=None,
                       help="training-set size (large_n, tokamak_large, "
                            "standard_map_large)")
    p_run.add_argument("--steps", type=int, default=None,
                       help="optimizer steps (large_n --distributed, "
                            "tokamak_large, standard_map_large)")
    p_run.add_argument("--sig2n", type=float, default=None,
                       help="fit jitter of tokamak_large and "
                            "standard_map_large (escalates x10 if the "
                            "float32 Cholesky rejects it)")
    p_run.add_argument("--backend", default=None,
                       choices=("generic", "kernel", "pallas"),
                       help="map-application backend: the float64 fast "
                            "path, or the fused rollout kernel in float32 "
                            "(pallas: an alias of kernel); overrides the "
                            "name's own")
    p_run.add_argument("--plots", default=None,
                       help="directory for portrait PNGs")
    p_run.add_argument("--distributed", action="store_true",
                       help="large_n: block-cyclic fit over the ranks of "
                            "torch.distributed")
    p_run.add_argument("--device", default="cuda",
                       help="torch device (default cuda)")
    p_run.add_argument("--with-reference", action="store_true",
                       help="also integrate the nm-turn plotting reference "
                            "(minutes in eager mode); gd always comes from "
                            "the one-turn reference")
    p_run.set_defaults(fn=cmd_run)

    p_list = sub.add_parser("list", help="list workloads")
    p_list.set_defaults(fn=cmd_list)

    p_sobol = sub.add_parser("sobol", help="tokamak Sobol sensitivity")
    p_sobol.add_argument("--n", type=int, default=128)
    p_sobol.add_argument("--turns", type=int, default=30)
    p_sobol.add_argument("--device", default="cuda",
                         help="torch device (default cuda)")
    p_sobol.set_defaults(fn=cmd_sobol)

    p_sample = sub.add_parser(
        "sample", help="HMC/NUTS over a workload's GP hyperposterior")
    p_sample.add_argument("workload")
    p_sample.add_argument("--sampler", default="nuts",
                          choices=("nuts", "hmc"))
    p_sample.add_argument("--chains", type=int, default=8)
    p_sample.add_argument("--samples", type=int, default=200)
    p_sample.add_argument("--warmup", type=int, default=200)
    p_sample.add_argument("--step-size", type=float, default=0.05)
    p_sample.add_argument("--leapfrog", type=int, default=16)
    p_sample.add_argument("--seed", type=int, default=0)
    p_sample.add_argument("--save", default=None,
                          help="write samples to this .npz")
    p_sample.add_argument("--device", default="cuda",
                          help="torch device (default cuda)")
    p_sample.set_defaults(fn=cmd_sample)

    p_bench = sub.add_parser("bench", help="the headline benchmark, or "
                             "large-N and rollout timings")
    p_bench.add_argument("--large-n", action="store_true",
                         help="the large-N pipeline's stages")
    p_bench.add_argument("--n", type=int, default=4096,
                         help="training-set size for --large-n")
    p_bench.add_argument("--reps", type=int, default=8)
    p_bench.add_argument("--rollout-sweep", action="store_true",
                         help="rollout kernel throughput against "
                              "training-set size")
    p_bench.add_argument("--distributed", action="store_true",
                         help="with --large-n: block-cyclic distributed "
                              "fit")
    p_bench.add_argument("--steps", type=int, default=None,
                         help="optimizer steps for --distributed")
    p_bench.add_argument("--device", default="cuda",
                         help="torch device (default cuda)")
    p_bench.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
