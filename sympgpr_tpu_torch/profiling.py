"""Spans, kernel timing and kernel launch counts of the port.

* ``span``: a named range of the program in ``torch.profiler``'s trace,
  recorded only while a profiler runs.  With none running it is one
  check of the profiler's state and returns a shared null context: no
  switch, no argument, no environment variable.  A span's parent is the
  span that encloses it in time on the same thread.  The spans:

  - the large-N fit (``gp/train.py::fit_sympgp_ondevice``):
    ``sympgpr::fit`` (one call, escalations included), in it
    ``sympgpr::fit.step`` (one Adam step) and ``sympgpr::fit.finish``
    (an attempt's history fetch; the last attempt's also the final
    build, factor, alpha solve and training error); in a step
    ``sympgpr::nll.build``, ``sympgpr::nll.factor``,
    ``sympgpr::linalg.tri_inv``, ``sympgpr::linalg.syrk``,
    ``sympgpr::nll.alpha`` (alpha and the value, after the syrk),
    ``sympgpr::nll.contraction`` and ``sympgpr::fit.update``;
  - the rollout (``ops/cuda_step.py``): ``sympgpr::rollout`` (one call of
    ``rollout_in_kernel``, the CPU path included), in a launch
    ``sympgpr::rollout.validate``, ``sympgpr::rollout.alloc`` and
    ``sympgpr::rollout.launch``;

* ``best_ms``: the one timer of the package, ``workloads/large_n.py`` and
  ``chip_smoke.py``: CUDA events around a call on a CUDA device, the host
  clock on the CPU, best of a few;
* ``count`` and ``launch_counts``: the one registry of launch counts.
  The wrappers of the hand-written kernels call ``count`` after each
  launch (``linalg/potrf.py`` once a factor, whose launches it issues
  from C); ``launch_counts`` reads (and optionally zeroes) them.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable

import torch
import torch.profiler


def _sync(device: torch.device | str | None) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# the hand-written kernels: the covariance build, the contraction, the
# syrk, the triangular matmul, the fit step's alpha product, the fit
# step's Cholesky written over Ky (one count a factor), the rollout
KERNELS = ("cov_fwd", "cov_bwd", "syrk", "trimm", "matvec", "potrf",
           "rollout")
# launches of ``rollout`` that ran cluster teams, those that ran a Split
# instance (``ops.cuda_step.split_instance``) and those in the mod_p / pdiff
# mode (``ops.cuda_step.kernel_mode`` "implicit_wrap"): not kernels of
# their own
SUBCOUNTS = ("rollout_cluster", "rollout_split", "rollout_wrap")
_COUNTS = dict.fromkeys(KERNELS + SUBCOUNTS, 0)

_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler runs,
    else one shared null context (nothing is made)."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def best_ms(fn: Callable[[], object], reps: int = 3, calls: int = 1,
            warmup: bool = True,
            device: torch.device | str | None = "cuda") -> float:
    """ms a call of ``fn``: best of ``reps`` timings of ``calls`` calls back
    to back (more than one lets a wrapper's host work overlap the card's
    for a short kernel), after one warm-up call (``warmup=False`` where
    the caller has just run ``fn``).

    On a CUDA ``device``, CUDA events on its current stream around the
    calls; on any other device (or None), ``time.perf_counter`` around
    them.  Each timed call is one eager call: nothing is chained or
    hoisted.
    """
    cuda = device is not None and torch.device(device).type == "cuda"
    if warmup:
        fn()
    _sync(device)
    best = math.inf
    for _ in range(reps):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / calls)
    return best


def count(key: str, n: int = 1) -> None:
    """Add ``n`` launches to ``key``, one of ``KERNELS + SUBCOUNTS`` (an
    unknown key raises ``KeyError``)."""
    _COUNTS[key] += n


def launch_counts(zero: bool = False) -> dict[str, int]:
    """Launches of each hand-written kernel in this process
    (``KERNELS``), then ``SUBCOUNTS``.  ``zero=True`` sets them to 0
    first."""
    if zero:
        _COUNTS.update(dict.fromkeys(_COUNTS, 0))
    return dict(_COUNTS)
