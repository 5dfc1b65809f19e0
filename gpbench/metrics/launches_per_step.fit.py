"""Kernel launches an Adam step: the launch calls in the host trace that
lie inside the ``sympgpr::fit.step`` spans starting in the traced window,
over the number of those spans."""
from gpbench.span_readers import launches_per_span


def read(ctx):
    return launches_per_span(ctx.trace, "sympgpr::fit.step")
