"""The rollout kernel's share of its roofline in the Split cell: the
launches' summed least time (``rooflines.rollout_bound``: FP32 issue,
exps on the SFUs, bytes) over their summed device time in the trace.  A
step works on one sub-map, so the bound counts one sub-map's training
and aux points as the configuration gives them, not the packed stride
(a multiple of 8)."""
from gpbench import rooflines
from gpbench.readers import elt, roofline_pct


def read(ctx):
    cfg, t = ctx.driver.config, ctx.driver.traffic
    b = rooflines.rollout_bound(t["orbits"], t["steps"], cfg["N"],
                                cfg["aux"]["points"], elt(cfg),
                                cfg["newton_iters"])["bound_ms"]
    return roofline_pct(ctx, ("rollout_kernel",),
                        lambda n: n["rollout_kernel"] * b)
