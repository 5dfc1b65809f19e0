"""The host's own time to issue one Adam step (ms): the median over the
``sympgpr::fit.step`` spans that start in the traced window of the span's
host duration less the time inside CUDA API calls (``cudaXxx``,
``cuXxx``).  Once the host runs some steps ahead, a launch waits inside
those calls for room in the launch queue, and a step's whole duration
reads the device's pace instead of the host's work."""
from gpbench.span_readers import own_ms


def read(ctx):
    return own_ms(ctx.trace, "sympgpr::fit.step", 50)
