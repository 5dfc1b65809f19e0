"""The rollout kernel's share of its roofline in the mod_p / pdiff mode:
``launches_wrap`` (the window's launches in that mode, the program's
``rollout_wrap`` count) x the least time of one launch over the kernel's
summed device time in the trace.  The least time is
``rooflines.rollout_bound`` at the configuration's real training and aux
points (not the packed stride, a multiple of 8) and Newton iterations,
with D's nm x B writes added to its bytes.  None without the kernel in
the trace, or where the program counts no launch in the mode."""
from gpbench import rooflines
from gpbench.readers import elt, named


def launch_bound_ms(cfg: dict, t: dict) -> float:
    e = elt(cfg)
    r = rooflines.rollout_bound(t["orbits"], t["steps"], cfg["N"],
                                cfg["aux"]["points"], e, cfg["newton_iters"])
    nbytes = r["bytes"] + e * t["steps"] * t["orbits"]
    return rooflines.bound_ms(nbytes, r["flops"], e == 8,
                              0.0 if e == 8 else r["exps"])[0]


def read(ctx):
    launches = ctx.counters.get("launches_wrap")
    ns, _ = ctx.trace.kernel_ns(named("rollout_kernel"))
    if not launches or ns <= 0:
        return None
    b = launch_bound_ms(ctx.driver.config, ctx.driver.traffic)
    return 100.0 * launches * b * 1e6 / ns
