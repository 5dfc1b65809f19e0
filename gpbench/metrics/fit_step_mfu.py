"""The large-N fit step's share of the chip's peak: the least time of one
Adam step (``rooflines.fit_step``: three n^3/3 products at 67 TFLOP/s and
the build's, contraction's and alpha solve's bytes at 3.35 TB/s) over the
traced run's fit step time (the end-to-end statistic: span of the whole
fits completed in the window over their Adam steps)."""
from gpbench import rooflines
from gpbench.readers import elt


def read(ctx):
    d = ctx.driver
    done = d._done()
    if not done:
        return None
    step_ms = 1e3 * (done[-1] - d.t_start) / (
        d.config["fit"]["steps"] * len(done))
    return 100.0 * rooflines.fit_step(d.config["N"], elt(d.config))[
        "bound_ms"] / step_ms
