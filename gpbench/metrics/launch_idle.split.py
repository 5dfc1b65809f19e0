"""Share of the traced window in which the device was idle while the host
was inside the program's rollout call (``sympgpr::rollout`` spans that
start in the window, each less the device's busy time under it); the rest
of the device's idle share is the client's."""
from gpbench.span_readers import idle_under_pct


def read(ctx):
    return idle_under_pct(ctx.trace, "sympgpr::rollout")
