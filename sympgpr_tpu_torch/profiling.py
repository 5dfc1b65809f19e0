"""Tracing, per-phase timing and kernel launch counts (PyTorch port of
``sympgpr_tpu/profiling.py``).

* ``PhaseTimer``: accumulating named phases that synchronise the CUDA
  device at their end, so a phase charges the card's work, not its
  dispatch;
* ``trace``: ``torch.profiler`` over a block, written as a Chrome trace
  (open it in ui.perfetto.dev or chrome://tracing);
* ``best_ms``: the one timer of the package, ``workloads/large_n.py`` and
  ``chip_smoke.py``: CUDA events around a call on a CUDA device, the host
  clock on the CPU, best of a few;
* ``launch_counts``: the launch counters of the hand-written kernels'
  wrappers, read (and optionally zeroed) in one place.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from collections import defaultdict
from typing import Callable

import torch


def _sync(device: torch.device | str | None) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulating named phase timer; a phase ends with a synchronise of
    ``device`` where it is a CUDA device (None: no synchronise).

    >>> t = PhaseTimer(device)
    >>> with t.phase("fit"):
    ...     ...
    >>> t.report()
    """

    def __init__(self, device: torch.device | str | None = "cuda"):
        self.device = device
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        yield
        if sync:
            # drain the stream so the phase charges device time
            _sync(self.device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k]}
            for k in self.totals
        }

    def __str__(self):
        return " | ".join(
            f"{k}: {v:.3f}s/{self.counts[k]}" for k, v in self.totals.items()
        )


@contextlib.contextmanager
def trace(logdir: str, path: str = "trace.json"):
    """``torch.profiler`` trace of the block (the CPU, and the CUDA device
    where there is one), written as a Chrome trace to ``logdir/path``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, path))


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


def launch_counts(zero: bool = False) -> dict[str, int]:
    """Launches of each hand-written kernel in this process, by the
    wrappers' counters: the covariance build (``cov_fwd``), the
    contraction (``cov_bwd``), the syrk, the triangular matmul (``trimm``)
    and the rollout.  ``zero=True`` sets them to 0 first."""
    from sympgpr_tpu_torch.ops import cuda_cov, cuda_step, cuda_syrk, \
        cuda_trimm

    if zero:
        cuda_cov.LAUNCHES_FWD = cuda_cov.LAUNCHES_BWD = 0
        cuda_syrk.LAUNCHES = cuda_trimm.LAUNCHES = cuda_step.LAUNCHES = 0
    return {"cov_fwd": cuda_cov.LAUNCHES_FWD,
            "cov_bwd": cuda_cov.LAUNCHES_BWD, "syrk": cuda_syrk.LAUNCHES,
            "trimm": cuda_trimm.LAUNCHES, "rollout": cuda_step.LAUNCHES}
