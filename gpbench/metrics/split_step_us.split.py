"""The rollout kernel's device time a sub-map step of the Split instance:
its summed device time in the traced window over (the window's Split
launches, ``launches_split``: the program's ``rollout_split`` count) x
(steps - 1), in us.  None without the kernel in the trace, or where the
program counts no Split launch."""
from gpbench.readers import named


def read(ctx):
    launches = ctx.counters.get("launches_split")
    ns, _ = ctx.trace.kernel_ns(named("rollout_kernel"))
    if not launches or ns <= 0:
        return None
    return ns * 1e-3 / (launches * (ctx.driver.traffic["steps"] - 1))
