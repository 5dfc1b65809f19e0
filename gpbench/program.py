"""The benchmark's one door into the program, ``sympgpr_tpu_torch``: its
kernels' build, the deployment and the calls that the windows time, its
launch counters and the names of its hand-written kernels.  Each call
takes what it passes to the program (the kernel, the noise, the wraps,
the fit's settings) from the configuration.  A call that a later traffic
kind needs is a file of its own, ``gpbench/calls/<name>.py`` with a
function ``call``; a driver names the calls it makes (``Driver.calls``)
and ``call(name)`` finds them.  Nothing else in ``gpbench/`` but those
files (and the tests) imports the program, and the reference imports
none of it.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from gpbench.harness import load_module

CALLS = ("deploy", "rollout", "fit_large")

# the hand-written kernels' names in a device trace (csrc/*.cu)
HANDWRITTEN = ("rollout_kernel", "cov_fwd_kernel", "cov_bwd_kernel",
               "cov_reduce_kernel", "trimm_kernel", "syrk_kernel")


def is_handwritten(kernel_name: str) -> bool:
    return any(k in kernel_name for k in HANDWRITTEN)


def build(libraries: list[str]) -> dict[str, float]:
    """Build (one nvcc each, all at once) and load the named libraries of
    the program's kernels into its own build directory; a library built
    before is only loaded.  Returns seconds by library."""
    from sympgpr_tpu_torch.ops import _build

    def timed(name: str) -> float:
        t = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t

    if not libraries:
        return {}
    with ThreadPoolExecutor(len(libraries)) as ex:
        secs = dict(zip(libraries, ex.map(timed, libraries)))
    for name in libraries:
        _build.load(name)
    return secs


def call_file(name: str):
    """The module ``gpbench/calls/<name>.py`` of a call not in ``CALLS``:
    its ``call`` and its ``control``."""
    path = Path(__file__).resolve().parent / "calls" / f"{name}.py"
    return load_module(path, f"gpbench_call_{name}")


def call(name: str):
    """The call into the program named ``name``: one of ``CALLS`` here, or
    ``call`` of ``gpbench/calls/<name>.py``."""
    return globals()[name] if name in CALLS else call_file(name).call


def _kernel(config: dict):
    from sympgpr_tpu_torch import get_kernel

    return get_kernel(config["kernel"])


def _sympgp_data(d: dict):
    X = torch.stack([d["q"], d["P"]], 1)
    z = torch.cat([d["p"] - d["P"], d["Q"] - d["q"]])
    return X, z


def deploy(config: dict, d: dict):
    """The packed deployment of a configuration's recorded hyperparameters
    on training set ``d``: the symplectic GP and the aux GP with the
    configuration's kernel, solved in float64 on the data's device
    (``SympGP.create``, ``AuxGP.create``), re-solved at the deployment
    jitter where the configuration has one (``for_deployment``), packed in
    the configuration's ``dtype`` with its ``mod_q`` and ``mod_p`` wraps
    (``pack_models``)."""
    from sympgpr_tpu_torch import AuxGP, SympGP
    from sympgpr_tpu_torch.ops.cuda_step import pack_models

    kern = _kernel(config)
    hyp, aux = config["hyperparameters"], config["aux"]
    X, z = _sympgp_data(d)
    sgp = SympGP.create(kern, hyp["sympgp"][:2], hyp["sympgp"][2],
                        config["sig2n"], X, z)
    na = aux["points"]
    Xa = torch.stack([d["q"][:na], d["p"][:na]], 1)
    agp = AuxGP.create(kern, hyp["aux"][:2], hyp["aux"][2], aux["sig2n"],
                       Xa, (d["P"] - d["p"])[:na], delta=True)
    jitter = config["deployment_jitter"]
    if jitter is not None:
        sgp, agp = sgp.for_deployment(jitter), agp.for_deployment(jitter)
    return pack_models(sgp, agp, mod_q=config["mod_q"],
                       mod_p=config["mod_p"],
                       dtype=getattr(torch, config["dtype"]))


def rollout(pm, q0: torch.Tensor, p0: torch.Tensor, nm: int, iters: int,
            loss_check: bool):
    """One launch of the fused rollout: (Q, P), each (nm, B)."""
    from sympgpr_tpu_torch.ops.cuda_step import rollout_in_kernel

    return rollout_in_kernel(pm, q0, p0, nm, iters=iters,
                             loss_check=loss_check)


def fit_large(config: dict, X: torch.Tensor, z: torch.Tensor):
    """The large-N fit: Adam on the device over the closed-form NLL with
    the configuration's kernel, then alpha at the trained hyperparameters.
    Returns a dict of the answer: theta (log10 of lx, ly, sig), the NLL
    history, alpha, train_mse and the noise used after any jitter
    escalation."""
    from sympgpr_tpu_torch import fit_sympgp_ondevice

    f = config["fit"]
    model, hist, mse, timings = fit_sympgp_ondevice(
        _kernel(config), X, z, sig2n=config["sig2n"], theta0=f["theta0"],
        steps=f["steps"], lr=f["lr"])
    hyp = torch.cat([model.params, model.sig.reshape(1)])
    return dict(theta=torch.log10(hyp), hist=hist, alpha=model.alpha,
                train_mse=mse, sig2n=timings["sig2n_used"],
                escalations=timings["jitter_escalations"])


def launch_counts() -> dict[str, int]:
    """Launches of each hand-written kernel so far in this process."""
    from sympgpr_tpu_torch import profiling

    return profiling.launch_counts()
