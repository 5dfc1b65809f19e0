"""Arithmetic that the per-layer metric readers share
(``gpbench/metrics/<metric>.py``): shares of a roofline over the traced
window, the device's idle share, and the step counts of the large-N fit.
A reader returns None where the trace holds nothing to read, never 0.
"""

from __future__ import annotations

from gpbench import rooflines
from gpbench.program import is_handwritten


def idle_pct(ctx) -> float | None:
    tr = ctx.trace
    span = tr.window[1] - tr.window[0]
    busy = tr.busy_ns()
    if span <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / span)


def named(part: str):
    return lambda name: part in name


def roofline_pct(ctx, kernels: tuple[str, ...], bound_ms_of_count) -> float | None:
    """100 x (the summed bounds of the launches) / (their summed device
    time); ``bound_ms_of_count(counts)`` gives the bounds in ms from the
    number of events of each named kernel."""
    counts, total_ns = {}, 0
    for k in kernels:
        ns, n = ctx.trace.kernel_ns(named(k))
        counts[k] = n
        total_ns += ns
    if total_ns <= 0:
        return None
    return 100.0 * bound_ms_of_count(counts) * 1e6 / total_ns


def adam_steps(ctx) -> int:
    """Adam steps the traced window ran: one syrk launch each."""
    _, n = ctx.trace.kernel_ns(named("syrk_kernel"))
    return n


def vendor_ms_per_step(ctx) -> float | None:
    steps = adam_steps(ctx)
    ns, _ = ctx.trace.kernel_ns(lambda n: not is_handwritten(n))
    if steps <= 0 or ns <= 0:
        return None
    return ns * 1e-6 / steps


def elt(config: dict) -> int:
    """Bytes an element of the configuration's ``dtype``."""
    return 4 if config["dtype"] == "float32" else 8


def rollout_bound_ms(ctx) -> float:
    cfg, t = ctx.driver.config, ctx.driver.traffic
    pm_ns = -(-cfg["N"] // 8) * 8
    pm_nas = -(-cfg["aux"]["points"] // 8) * 8
    return rooflines.rollout_bound(t["orbits"], t["steps"], pm_ns, pm_nas,
                                   elt(cfg), cfg["newton_iters"])["bound_ms"]
