"""The rollout kernel's share of its roofline: the launches' summed least
time (``rooflines.rollout_bound``: FP32 issue, exps on the SFUs, bytes)
over their summed device time in the trace."""
from gpbench.readers import roofline_pct, rollout_bound_ms


def read(ctx):
    b = rollout_bound_ms(ctx)
    return roofline_pct(ctx, ("rollout_kernel",),
                        lambda n: n["rollout_kernel"] * b)
