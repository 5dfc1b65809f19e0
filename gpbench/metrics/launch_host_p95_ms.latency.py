"""95th percentile of the host durations (ms) of the program's rollout
calls that start in the traced window (``sympgpr::rollout`` spans: the
launch's checks, allocations and the kernel's launch)."""
from gpbench.span_readers import percentile_ms


def read(ctx):
    return percentile_ms(ctx.trace, "sympgpr::rollout", 95)
