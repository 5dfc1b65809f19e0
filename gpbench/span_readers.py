"""Arithmetic that the readers of the program's own spans share: the
``sympgpr::`` ranges that ``sympgpr_tpu_torch.profiling.span`` records in
the profiler's trace while it runs.  A span counts where it starts in the
traced window.  From those spans: their host durations, with or without
the time inside the CUDA runtime's calls, the kernel launches the host
made inside them, and the device's idle time under them.  A reader
returns None where the window holds none of its spans (as in the trace of
a program that records none), never 0.
"""

from __future__ import annotations

import bisect

import numpy as np

# the host calls that launch a kernel, as the profiler names the CUDA
# API's calls in its trace: the names an H100 trace of
# the large-N fit shows (PyTorch's and the libraries' kernels, and the
# program's kernels through ctypes)
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel"})


def _cuda_call(name: str) -> bool:
    return name.startswith("cuda") or (name.startswith("cu")
                                        and name[2:3].isupper())


def in_window(trace, name: str) -> list[tuple[int, int]]:
    """(start, end) in ns of the host ranges named ``name`` that start in
    the window, in order of start."""
    lo, hi = trace.window
    return sorted((a, b) for n, a, b in trace.host
                  if n == name and lo <= a <= hi)


def percentile_ms(trace, name: str, q: float) -> float | None:
    """The ``q``-th percentile (numpy's linear rule) of the host durations
    of the spans ``name`` in the window, in ms."""
    spans = in_window(trace, name)
    if not spans:
        return None
    return 1e-6 * float(np.percentile([b - a for a, b in spans], q))


def own_ms(trace, name: str, q: float) -> float | None:
    """The ``q``-th percentile over the spans ``name`` in the window of
    the span's host duration less the time inside the CUDA API's calls in
    it (``cudaXxx``, ``cuXxx``), in ms: the host's
    own work, without the waits for room in the launch queue, which those
    calls hold once the host runs ahead of the device."""
    spans = in_window(trace, name)
    if not spans:
        return None
    calls = sorted((a, b) for n, a, b in trace.host if _cuda_call(n))
    starts = [a for a, _ in calls]
    own = []
    for a, b in spans:
        i = bisect.bisect_left(starts, a)
        inner = []
        while i < len(calls) and calls[i][0] <= b:
            inner.append((calls[i][0], min(calls[i][1], b)))
            i += 1
        starts_in, ends_in = _merged(inner)
        own.append((b - a) - (sum(ends_in) - sum(starts_in)))
    return 1e-6 * float(np.percentile(own, q))


def launches_per_span(trace, name: str) -> float | None:
    """Kernel launches (``LAUNCH_CALLS``) that lie inside the spans
    ``name`` of the window, over the number of those spans."""
    spans = in_window(trace, name)
    if not spans:
        return None
    calls = sorted((a, b) for n, a, b in trace.host if n in LAUNCH_CALLS)
    starts = [a for a, _ in calls]
    count = 0
    for a, b in spans:
        i = bisect.bisect_left(starts, a)
        while i < len(calls) and calls[i][0] <= b:
            count += calls[i][1] <= b
            i += 1
    return count / len(spans)


def _merged(intervals: list) -> tuple[list[int], list[int]]:
    """The union of (start, end) intervals as disjoint intervals in
    order: (starts, ends)."""
    starts, ends = [], []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def idle_under_pct(trace, name: str) -> float | None:
    """100 x the summed time under the spans ``name`` of the window in
    which no device operation ran (each span's length less
    ``Trace.busy_ns`` over it), over the window's length."""
    spans = in_window(trace, name)
    lo, hi = trace.window
    if not spans or hi <= lo:
        return None
    starts, ends = _merged([(a, b) for _, a, b in trace.device])
    idle = 0
    for a, b in spans:
        busy = 0
        i = bisect.bisect_right(ends, a)
        while i < len(starts) and starts[i] < b:
            busy += min(ends[i], b) - max(starts[i], a)
            i += 1
        idle += (b - a) - busy
    return 100.0 * idle / (hi - lo)
